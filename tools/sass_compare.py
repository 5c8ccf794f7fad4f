"""Compare the kernels of two ``cuobjdump -sass`` dumps instruction word by
instruction word.

Each function's listing is reduced to its instructions and their 128-bit
encodings: the ``/*0000*/`` address column goes, and runs of blanks are
collapsed (the dump pads its columns to the widest address of the file, so
a longer file shifts every line). One line a function: ``same`` when the
instruction words are equal, ``DIFFER`` with the count of differing lines
otherwise, ``new``/``gone`` for a function only one dump holds.

    cuobjdump -sass libA.so > a.txt; cuobjdump -sass libB.so > b.txt
    python3 tools/sass_compare.py a.txt b.txt
"""

import argparse
import difflib
import re
import sys


def short_name(mangled):
    """``flash_fwd_kernel_f32<192, 16>`` of its mangled name: the nested
    name's last component and its integer template arguments, without the
    anonymous namespace (whose name carries a per-build hash)."""
    if not mangled.startswith("_ZN"):
        return mangled
    rest, name = mangled[3:], mangled
    while rest[:1].isdigit():
        n = int(re.match(r"\d+", rest).group(0))
        rest = rest[len(str(n)):]
        name, rest = rest[:n], rest[n:]
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    return name + (f"<{', '.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>" if args else "")


def functions(path):
    """{short kernel name: [normalised lines]}; the short name drops the
    anonymous namespace's per-build hash."""
    out, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = short_name(m.group(1))
                out[name] = []
                continue
            if name is None or line.lstrip().startswith("."):
                continue
            s = " ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split())
            if s:
                out[name].append(s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", help="cuobjdump -sass output of the first build")
    ap.add_argument("after", help="cuobjdump -sass output of the second build")
    args = ap.parse_args(argv)
    a, b = functions(args.before), functions(args.after)
    for name in sorted(set(a) | set(b)):
        if name not in a:
            print(f"new    {name} ({len(b[name])} lines)")
        elif name not in b:
            print(f"gone   {name}")
        elif a[name] == b[name]:
            print(f"same   {name} ({len(a[name])} lines)")
        else:
            diff = sum(1 for d in difflib.ndiff(a[name], b[name]) if d[:1] in "+-")
            print(f"DIFFER {name} ({len(a[name])} -> {len(b[name])} lines, {diff} differ)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
