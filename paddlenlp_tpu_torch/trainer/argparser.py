"""Dataclass argument parser (reference: paddlenlp/trainer/argparser.py —
``PdArgumentParser``: dataclass->argparse with JSON config-file support, the
``llm/config/<model>/*.json`` launch format).

A copy of ``paddlenlp_tpu/trainer/argparser.py``."""

from __future__ import annotations

import dataclasses
import json
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, NewType, Tuple, Union, get_args, get_origin, get_type_hints

DataClass = NewType("DataClass", Any)

__all__ = ["PdArgumentParser"]


def _string_to_bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"can't parse {v!r} as bool")


class PdArgumentParser(ArgumentParser):
    def __init__(self, dataclass_types, **kwargs):
        kwargs.setdefault("formatter_class", ArgumentDefaultsHelpFormatter)
        super().__init__(**kwargs)
        if dataclasses.is_dataclass(dataclass_types):
            dataclass_types = [dataclass_types]
        self.dataclass_types = list(dataclass_types)
        for dtype in self.dataclass_types:
            self._add_dataclass_arguments(dtype)

    def _add_dataclass_arguments(self, dtype):
        hints = get_type_hints(dtype)
        for f in dataclasses.fields(dtype):
            if not f.init:
                continue
            self._parse_dataclass_field(f, hints[f.name])

    def _parse_dataclass_field(self, f: dataclasses.Field, field_type):
        field_name = f"--{f.name}"
        kwargs: Dict[str, Any] = dict(f.metadata)
        origin = get_origin(field_type)
        args_t = get_args(field_type)
        if origin is Union:
            non_none = [a for a in args_t if a is not type(None)]
            field_type = non_none[0] if non_none else str
            origin = get_origin(field_type)
            args_t = get_args(field_type)
        if isinstance(field_type, type) and issubclass(field_type, Enum):
            kwargs["type"] = type(list(field_type)[0].value)
            kwargs["choices"] = [e.value for e in field_type]
            kwargs["default"] = f.default.value if isinstance(f.default, Enum) else f.default
        elif field_type is bool:
            kwargs["type"] = _string_to_bool
            kwargs["nargs"] = "?"
            kwargs["const"] = True
            if f.default is not dataclasses.MISSING:
                kwargs["default"] = f.default
        elif origin in (list, List):
            kwargs["type"] = args_t[0] if args_t else str
            kwargs["nargs"] = "+"
            if f.default_factory is not dataclasses.MISSING:
                kwargs["default"] = f.default_factory()
            elif f.default is not dataclasses.MISSING:
                kwargs["default"] = f.default
        else:
            kwargs["type"] = field_type
            if f.default is not dataclasses.MISSING:
                kwargs["default"] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                kwargs["default"] = f.default_factory()
            else:
                kwargs["required"] = True
        self.add_argument(field_name, **kwargs)

    def parse_args_into_dataclasses(
        self, args=None, return_remaining_strings=False, look_for_args_file=True
    ) -> Tuple[DataClass, ...]:
        if args is None:
            args = sys.argv[1:]
        # the launch convention: a single .json positional is the whole config
        if len(args) == 1 and args[0].endswith(".json"):
            return self.parse_json_file(args[0])
        namespace, remaining = self.parse_known_args(args)
        outputs = []
        for dtype in self.dataclass_types:
            keys = {f.name for f in dataclasses.fields(dtype) if f.init}
            inputs = {k: v for k, v in vars(namespace).items() if k in keys}
            outputs.append(dtype(**inputs))
        if return_remaining_strings:
            return (*outputs, remaining)
        if remaining:
            raise ValueError(f"unparsed arguments: {remaining}")
        return tuple(outputs)

    def parse_json_file(self, json_file: str, return_remaining=False) -> Tuple[DataClass, ...]:
        data = json.loads(Path(json_file).read_text())
        return self.parse_dict(data, return_remaining=return_remaining)

    def parse_dict(self, data: Dict[str, Any], return_remaining=False) -> Tuple[DataClass, ...]:
        unused = dict(data)
        outputs = []
        for dtype in self.dataclass_types:
            keys = {f.name for f in dataclasses.fields(dtype) if f.init}
            inputs = {k: v for k, v in data.items() if k in keys}
            for k in inputs:
                unused.pop(k, None)
            outputs.append(dtype(**inputs))
        if return_remaining:
            return (*outputs, unused)
        if unused:
            raise ValueError(f"unused config keys: {sorted(unused)}")
        return tuple(outputs)
