# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/utils/cli.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# Dataclass-driven CLI parsing.
#
# Capability parity: the reference parses flat dataclass configs with
# transformers.HfArgumentParser (touchnet/bin/train.py:634-636). We provide an
# equivalent built on argparse so the framework has no hard transformers
# dependency at config time.

import argparse
import dataclasses
import json
import os
import sys
import typing
from typing import Any, List, Optional, Sequence, Tuple, Type


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def add_dataclass_arguments(parser: argparse.ArgumentParser, dc: Type) -> None:
    """Register one ``--<field>`` argument per dataclass field."""
    group = parser.add_argument_group(dc.__name__)
    for f in dataclasses.fields(dc):
        tp = _unwrap_optional(f.type if not isinstance(f.type, str) else eval(f.type))  # noqa: S307
        kwargs: dict = {}
        if f.default is not dataclasses.MISSING:
            kwargs["default"] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            kwargs["default"] = f.default_factory()  # type: ignore[misc]
        else:
            kwargs["required"] = True
        help_text = f.metadata.get("help", "") if f.metadata else ""
        kwargs["help"] = help_text
        origin = typing.get_origin(tp)
        if tp is bool:
            kwargs["type"] = _str2bool
            kwargs["nargs"] = "?"
            kwargs["const"] = True
        elif origin in (list, List):
            (elem_tp,) = typing.get_args(tp)
            kwargs["type"] = elem_tp
            kwargs["nargs"] = "+"
        elif tp in (int, float, str):
            kwargs["type"] = tp
        else:
            kwargs["type"] = str
        group.add_argument(f"--{f.name}", **kwargs)


def parse_args_into_dataclasses(
    dataclass_types: Sequence[Type],
    args: Optional[Sequence[str]] = None,
    allow_extra: bool = False,
) -> Tuple[Any, ...]:
    """Parse CLI args into instances of the given dataclasses.

    Fields with the same name across dataclasses must not conflict; the
    reference keeps them disjoint via ``training_``/``dataset_``/... prefixes.
    """
    parser = argparse.ArgumentParser(allow_abbrev=False)
    seen = set()
    for dc in dataclass_types:
        for f in dataclasses.fields(dc):
            if f.name in seen:
                raise ValueError(f"duplicate config field across dataclasses: {f.name}")
            seen.add(f.name)
        add_dataclass_arguments(parser, dc)
    if allow_extra:
        namespace, _ = parser.parse_known_args(args)
    else:
        namespace = parser.parse_args(args)
    out = []
    for dc in dataclass_types:
        names = {f.name for f in dataclasses.fields(dc)}
        out.append(dc(**{k: v for k, v in vars(namespace).items() if k in names}))
    return tuple(out)


def dump_config_json(config: Any, path: str) -> None:
    """Serialize a dataclass config to JSON (the reference dumps every config
    into the experiment dir at startup, touchnet/bin/train.py:133-141)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, default=str)
        f.write("\n")


def main_args() -> List[str]:
    return sys.argv[1:]
