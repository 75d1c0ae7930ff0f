"""The data CLIs' flags, on ``argparse``.

The port's own copy of the flag table of ``instageo_tpu/data/flags.py`` and
of the raster chip creator's flags: the same names, defaults, enum choices
and bounds, and absl's spellings (``--f=v``, ``--f v``, a bare ``--flag``
and ``--noflag`` for a boolean, ``--flag=true|false``, comma lists for
``mask_types`` and ``filters``). One flag the JAX CLIs lack: ``--device``
(``cuda`` by default), where the chip math runs.

``parse_flags`` returns a namespace; ``present`` on it holds the names
given on the command line.
"""

from __future__ import annotations

import argparse
import csv
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from instageo_tpu_torch.ops.chip_ops import MASK_DECODING_POS

CHIP_WINDOW_DEFAULT = 0


@dataclass(frozen=True)
class Flag:
    name: str
    kind: str  # string | integer | float | bool | enum | list
    default: Any
    help: str
    choices: Optional[Sequence[str]] = None
    lower: Optional[float] = None
    upper: Optional[float] = None


COMMON_FLAGS = (
    Flag("dataframe_path", "string", None, "Path to the DataFrame CSV/Parquet file."),
    Flag("data_format", "enum", "csv", "Format of the observations file.",
         choices=("csv", "parquet")),
    Flag("processing_method", "enum", "cog",
         "How to obtain granule data: 'cog' streams chips straight from remote "
         "COGs; 'download' fetches whole granule assets locally first, then "
         "chips from the local files; 'download-only' fetches the granules "
         "and stops.", choices=("cog", "download", "download-only")),
    Flag("filters", "list", [], "Parquet filters as col:op:value triplets."),
    Flag("chip_size", "integer", 256, "Size of each chip."),
    Flag("output_directory", "string", None,
         "Directory where the chips and segmentation maps will be saved."),
    Flag("min_count", "integer", 100, "Minimum observation counts per tile."),
    Flag("src_crs", "integer", 4326, "EPSG code of the points' source CRS."),
    Flag("spatial_resolution", "float", 0.0002694945852358564,
         "Spatial resolution of the chip grid (CRS units/pixel)."),
    Flag("shift_to_month_start", "bool", True,
         "Shift observation dates back to a month start (`date - "
         "MonthBegin(1)`: dates already on the 1st roll back to the "
         "previous month's start)."),
    Flag("is_time_series_task", "bool", True,
         "Whether multiple timesteps are fetched per observation."),
    Flag("num_steps", "integer", 3, "Number of temporal steps."),
    Flag("temporal_step", "integer", 30, "Temporal step size in days."),
    Flag("temporal_tolerance", "integer", 5,
         "Tolerance (days) when searching for the closest tile."),
    Flag("temporal_tolerance_minutes", "integer", 0, "Additional tolerance in minutes."),
    Flag("data_source", "enum", "HLS", "Data source to use.", choices=("HLS", "S2", "S1")),
    Flag("cloud_coverage", "integer", 10, "Max percentage cloud cover per granule.",
         lower=0, upper=100),
    Flag("window_size", "integer", CHIP_WINDOW_DEFAULT,
         "Half-size of the label window around each observation pixel.", lower=0),
    Flag("mask_types", "list", [], "List of masking types to apply."),
    Flag("masking_strategy", "enum", "each",
         "'each' = per-timestep masking; 'any' = collapse over time.",
         choices=("each", "any")),
    Flag("daytime_only", "bool", False, "Select only daytime satellite observations."),
    Flag("task_type", "enum", "seg", "'seg' saves int labels; 'reg' saves float32 labels.",
         choices=("seg", "reg")),
    Flag("device", "string", "cuda",
         "Device of the chip math: 'cuda' (a card is required) or 'cpu'."),
)

RASTER_FLAGS = (
    Flag("records_file", "string", None,
         "CSV of label rasters (label_filename, date columns)."),
    Flag("raster_path", "string", "", "Directory holding label rasters."),
    Flag("qa_check", "bool", True, "Run chip/label QA checks."),
    Flag("is_bbox_feature", "bool", False,
         "Records are bounding boxes (no labels produced)."),
    Flag("bbox_feature_path", "string", None, "JSON file containing bounding boxes."),
    Flag("date", "string", None, "Acquisition date for bbox features."),
)

_TRUE = ("true", "t", "1")
_FALSE = ("false", "f", "0")


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"{s!r} is not a boolean (true/false)")


def _parse_list(s: str) -> List[str]:
    """A comma list, as absl's ``DEFINE_list`` reads it (CSV rules)."""
    if not s:
        return []
    return [v.strip() for v in next(csv.reader([s], strict=True))]


def _converter(flag: Flag) -> Callable[[str], Any]:
    base = {"string": str, "integer": int, "float": float, "bool": _parse_bool,
            "enum": str, "list": _parse_list}[flag.kind]

    def convert(s: str) -> Any:
        try:
            v = base(s)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{s!r} is not a valid {flag.kind}") from None
        if flag.choices is not None and v not in flag.choices:
            raise argparse.ArgumentTypeError(f"{s!r} is not one of {list(flag.choices)}")
        if flag.lower is not None and v < flag.lower:
            raise argparse.ArgumentTypeError(f"{v} is below {flag.lower}")
        if flag.upper is not None and v > flag.upper:
            raise argparse.ArgumentTypeError(f"{v} is above {flag.upper}")
        if flag.name == "mask_types" and not all(t in MASK_DECODING_POS["HLS"] for t in v):
            raise argparse.ArgumentTypeError(
                f"Valid values are {list(MASK_DECODING_POS['HLS'])}")
        return v

    convert.__name__ = flag.kind
    return convert


def _absl_spelling(argv: Sequence[str], names: Sequence[str],
                   bools: Sequence[str]) -> List[str]:
    """argv with each flag of the table written ``--name[=value]`` (absl also
    takes one dash), and a bare ``--flag`` or ``--noflag`` of a boolean
    written ``--flag=true`` or ``--flag=false``."""
    out = []
    for arg in argv:
        if arg.startswith("-"):
            name, eq, value = arg.lstrip("-").partition("=")
            if not eq and name in bools:
                arg = f"--{name}=true"
            elif not eq and name.startswith("no") and name[2:] in bools:
                arg = f"--{name[2:]}=false"
            elif name in names:
                arg = f"--{name}{eq}{value}"
        out.append(arg)
    return out


def parse_flags(argv: Sequence[str], table: Sequence[Flag] = COMMON_FLAGS,
                prog: Optional[str] = None) -> argparse.Namespace:
    """Parse ``argv`` (without the program name) against ``table``. An
    unknown flag or a bad value exits with status 2 and a message, as
    ``argparse`` does."""
    parser = argparse.ArgumentParser(prog=prog, allow_abbrev=False)
    for f in table:
        parser.add_argument(f"--{f.name}", type=_converter(f),
                            default=list(f.default) if f.kind == "list" else f.default,
                            help=f.help, metavar=f.kind.upper())
    names = {f.name for f in table}
    args = _absl_spelling(argv, names, [f.name for f in table if f.kind == "bool"])
    ns = parser.parse_args(args)
    ns.present = {a[2:].split("=", 1)[0] for a in args if a.startswith("--")} & names
    return ns


def window_size_with_default(flags: argparse.Namespace, default: int) -> int:
    """``window_size`` with the caller's default applied unless the flag was
    given on the command line (the JAX data cleaner registers the same name
    with another default in absl's process-wide registry; the port's
    cleaner has a table of its own, ``data_cleaner.CLEANER_FLAGS``)."""
    if "window_size" in flags.present or default == CHIP_WINDOW_DEFAULT:
        return int(flags.window_size)
    return default


def chip_window_size(flags: argparse.Namespace) -> int:
    return window_size_with_default(flags, CHIP_WINDOW_DEFAULT)
