"""Time the fp32 paged-attention route of one or more checkouts on one CUDA card, in turns.

From the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/paged_f32_compare.py [--root DIR ...] [--rounds 2] [--ppo] [--sweep] [--seed 0]

Each root (default: this checkout) runs in a subprocess of its own, which
imports that root's ``paddlenlp_tpu_torch`` (building its kernels on first
use) and times its ``ragged_paged_attention`` on every case of this
checkout's ``chip_smoke.CASES`` that takes fp32 queries or an fp32 pool:
CUDA events over 20 calls with the L2 flushed before each
(``chip_smoke.time_cuda``), each output held against that root's plain
version. With ``--sweep`` the cases of at most 5 query tokens are timed
again at each partition length of the kv walk (64 positions to the tables'
capacity) in place of ``kv_partitions``'s choice. With ``--ppo`` the
subprocess then rolls out one round of PPO as the ``ppo`` phase of
``chip_smoke.py`` does (``PPOTrainer.rollout``: 2 prompts of 130 and 256
tokens, 4 rollouts each, 32 new tokens, one fp32 engine) over a
Qwen2-1.5B with random weights from ``--seed``, once warm and once under
``torch.profiler``: the paged kernels' device ms (merges included), every
kernel's, and the round's wall. The roots run in turns, ``--rounds`` times
over (two roots and two rounds: A, B, B, A), each printing one JSON line;
the card's name and power limit come first. Compare two commits by giving the
parent's ``git archive`` as the first root and this checkout as the second.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's ``chip_smoke`` (the cases, the bound, the timer),
    whichever root's package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def ppo_round(torch, cs, pa, seed):
    """One PPO rollout round as the ``ppo`` phase rolls it out, warm, then
    profiled: ``chip_smoke.rollout_profile`` of the round."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from paddlenlp_tpu_torch.trainer import TrainingArguments
    from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM
    from paddlenlp_tpu_torch.trl import PPOConfig, PPOTrainer

    rng = np.random.default_rng(seed)
    cfg = Qwen2Config(**cs.QWEN2_1_5B)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (130, 256)]
    policy = Qwen2ForCausalLM.from_config(cfg, seed=seed, device=cs.DEVICE)
    with tempfile.TemporaryDirectory(prefix="paged_f32_compare_") as out_dir:
        args = TrainingArguments(output_dir=out_dir, per_device_train_batch_size=2, max_steps=1, save_strategy="no",
                                 seed=seed)
        trainer = PPOTrainer(model=policy, reward_fn=lambda ids, mask: 0.0, args=args,
                             train_dataset=[{"input_ids": p} for p in prompts],
                             ppo_config=PPOConfig(num_rollouts_per_prompt=4, max_new_tokens=32, max_prompt_length=256))
        trainer.rollout(prompts)  # warm: the engine, its pool and the kernels' first calls
        torch.cuda.synchronize()
        calls = pa.LAUNCHES
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.rollout(prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return cs.rollout_profile(torch, prof, wall, pa.LAUNCHES - calls)


def run_one(root, seed, ppo, sweep):
    """The cases (and the PPO round) on ``root``'s package: one JSON object."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from paddlenlp_tpu_torch.experimental.paged_cache import quantize_kv
    from paddlenlp_tpu_torch.ops import paged_attention as pa

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=cs.DEVICE)  # > 50 MB L2
    t0 = time.perf_counter()
    cases = []
    for batch, q_dtype, kv in cs.CASES:
        if q_dtype != "float32" and kv != "fp32":
            continue
        args = cs.kernel_case(torch, quantize_kv, batch, q_dtype, kv, seed)
        out = pa.ragged_paged_attention(**args)
        ref = pa.ragged_paged_attention_ref(**args)
        torch.cuda.synchronize()
        cases.append(dict(case=f"{batch} {q_dtype} {kv}", route=pa.kernel_route(args["q"].dtype, args["pool_k"].dtype),
                          max_abs_err=(out.float() - ref.float()).abs().max().item(),
                          ms=cs.time_cuda(torch, lambda: pa.ragged_paged_attention(**args), 20, flush)))
        del args, out, ref
    sweeps = {}
    if sweep:  # the decode-sized cases at each partition length, the wrapper's own choice replaced
        real = pa.kv_partitions
        try:
            for batch, q_dtype, kv in cs.CASES:
                if (q_dtype != "float32" and kv != "fp32") or cs.BATCHES[batch][0] > 5:
                    continue
                args = cs.kernel_case(torch, quantize_kv, batch, q_dtype, kv, seed)
                cap = args["block_tables"].shape[1] * args["pool_k"].shape[2]
                times = {}
                for part_len in (64, 128, 256, 512, 1024, -(-cap // 64) * 64):
                    pa.kv_partitions = lambda *a, n=part_len, **kw: (-(-cap // n), n)  # noqa: E731
                    times[part_len] = cs.time_cuda(torch, lambda: pa.ragged_paged_attention(**args), 20, flush)
                sweeps[f"{batch} {q_dtype} {kv}"] = times
                del args
        finally:
            pa.kv_partitions = real
    del flush
    torch.cuda.empty_cache()
    res = dict(root=os.path.abspath(root), package=os.path.dirname(os.path.dirname(pa.__file__)), cases=cases,
               part_len_ms=sweeps, seconds=time.perf_counter() - t0)
    if ppo:
        res["ppo_round"] = ppo_round(torch, cs, pa, seed)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout to time (repeat; default: this one)")
    ap.add_argument("--rounds", type=int, default=1, help="turns over the roots; odd turns run them in reverse")
    ap.add_argument("--ppo", action="store_true", help="also profile one PPO rollout round on each root")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the decode-sized cases at partition lengths of 64 to the tables' capacity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the subprocess of one root
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one, args.seed, args.ppo, args.sweep)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("paged_f32_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    print(cs.nvidia_smi(), flush=True)
    roots = args.root or [HERE]
    for turn in range(args.rounds):
        for root in roots if turn % 2 == 0 else roots[::-1]:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root, "--seed", str(args.seed)]
            cmd += (["--ppo"] if args.ppo else []) + (["--sweep"] if args.sweep else [])
            proc = subprocess.run(cmd, cwd=HERE, stdout=subprocess.PIPE, text=True)
            if proc.returncode != 0:
                print(f"paged_f32_compare: {root} failed (exit {proc.returncode})", file=sys.stderr)
                return proc.returncode
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(turn=turn, **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
