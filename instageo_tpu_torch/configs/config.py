"""Hydra-style configuration: YAML files plus dotted CLI overrides.

Counterpart of ``instageo_tpu/configs/config.py`` with the same surface
(``--config-name``/``--config-path``, ``key=value`` and ``+key=value``
overrides typed as YAML, attribute access ``cfg.train.batch_size``,
``.hydra/config.yaml`` in the run directory). PyYAML is not a dependency of
the port: this module reads and writes the YAML subset the shipped configs
use, which is block mappings (and block sequences), flow lists and maps
that may span lines, ``#`` comments, quoted strings, and plain scalars
resolved as PyYAML's YAML 1.1 resolvers do (null, bool, int in its
decimal/octal/hex/binary/sexagesimal forms, float with a dot, and
date-only timestamps). Anchors, tags, multi-document streams and block
scalars (``|``, ``>``) are not read; an override that is not valid YAML
stays the raw string, as with ``yaml.safe_load``.
"""

from __future__ import annotations

import copy
import datetime
import math
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

_CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))


class YamlError(ValueError):
    """Text outside the YAML subset this module reads."""


# --- scalars: PyYAML's implicit resolvers (yaml/resolver.py) -----------------

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9_]+(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    body = t.lstrip("+-")
    if ":" in body:
        return _sexagesimal(t, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t in (".nan",):
        return math.nan
    if t.endswith(".inf"):
        return -math.inf if t[0] == "-" else math.inf
    if ":" in t:
        return float(_sexagesimal(t, float))
    return float(t)


def resolve_scalar(text: str) -> Any:
    """A plain (unquoted) scalar's value, as PyYAML's safe loader types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    m = _DATE.match(text)
    if m:
        return datetime.date(*map(int, m.groups()))
    return text


# --- the reader --------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after blank
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _depth(text: str) -> int:
    """Open flow brackets left at the end of ``text`` (outside quotes)."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of each non-blank line, comments stripped and a
    flow collection that spans lines joined into one."""
    out: List[Tuple[int, str]] = []
    pending: Optional[List] = None
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs in indentation")
        line = _strip_comment(raw)
        if pending is not None:
            pending[1] += " " + line.strip()
            if _depth(pending[1]) <= 0:
                out.append(tuple(pending))
                pending = None
            continue
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            continue
        entry = [len(line) - len(line.lstrip(" ")), line.strip()]
        if _depth(entry[1]) > 0:
            pending = entry
        else:
            out.append(tuple(entry))
    if pending is not None:
        raise YamlError("unclosed flow collection")
    return out


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            nxt = text[i + 1:i + 2]
            out.append({"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0",
                        "r": "\r"}.get(nxt, "\\" + nxt))
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlError("unclosed quote")


def _plain_flow(text: str, pos: int, in_map: bool) -> Tuple[str, int]:
    """A plain scalar inside a flow collection, up to ``,``, ``]``, ``}``,
    or (as a flow-map key) ``: ``."""
    i = pos
    while i < len(text):
        ch = text[i]
        if ch in ",]}[{":
            break
        if ch == ":" and (i + 1 == len(text) or text[i + 1] in " ,]}") and in_map:
            break
        i += 1
    return text[pos:i].strip(), i


def _skip(text: str, pos: int) -> int:
    while pos < len(text) and text[pos] in " \t":
        pos += 1
    return pos


def _flow_value(text: str, pos: int, in_map: bool = False) -> Tuple[Any, int]:
    pos = _skip(text, pos)
    if pos >= len(text):
        raise YamlError("flow collection ends early")
    ch = text[pos]
    if ch == "[":
        items: List[Any] = []
        pos = _skip(text, pos + 1)
        while True:
            if pos >= len(text):
                raise YamlError("unclosed [")
            if text[pos] == "]":
                return items, pos + 1
            value, pos = _flow_value(text, pos)
            items.append(value)
            pos = _skip(text, pos)
            if pos < len(text) and text[pos] == ",":
                pos = _skip(text, pos + 1)
            elif pos >= len(text) or text[pos] != "]":
                raise YamlError(f"expected , or ] in {text!r}")
    if ch == "{":
        mapping: Dict[Any, Any] = {}
        pos = _skip(text, pos + 1)
        while True:
            if pos >= len(text):
                raise YamlError("unclosed {")
            if text[pos] == "}":
                return mapping, pos + 1
            key, pos = _flow_value(text, pos, in_map=True)
            pos = _skip(text, pos)
            value = None
            if pos < len(text) and text[pos] == ":":
                nxt = _skip(text, pos + 1)
                if nxt < len(text) and text[nxt] in ",}":
                    pos = nxt
                else:
                    value, pos = _flow_value(text, pos + 1)
            mapping[key] = value
            pos = _skip(text, pos)
            if pos < len(text) and text[pos] == ",":
                pos = _skip(text, pos + 1)
            elif pos >= len(text) or text[pos] != "}":
                raise YamlError(f"expected , or }} in {text!r}")
    if ch in "'\"":
        return _quoted(text, pos)
    if ch in "]},":
        raise YamlError(f"unexpected {ch!r} in {text!r}")
    plain, end = _plain_flow(text, pos, in_map)
    return resolve_scalar(plain), end


def _node(text: str) -> Any:
    """The value of one line's worth of YAML: flow, quoted or plain."""
    text = text.strip()
    if text[:1] in "&*!|>%@`":
        raise YamlError(f"unsupported YAML construct {text[:1]!r}")
    if text[:1] in "[{'\"":
        value, end = _flow_value(text, 0)
        if text[end:].strip():
            raise YamlError(f"trailing text after {text[:end]!r}")
        return value
    return resolve_scalar(text)


def _key_split(content: str) -> Optional[Tuple[str, str]]:
    """(key, rest) when ``content`` is a mapping entry ``key: rest``."""
    if content[:1] in "'\"":
        _, end = _quoted(content, 0)
        if content[end:end + 1] == ":" and content[end + 1:end + 2] in ("", " "):
            return content[:end], content[end + 1:].strip()
        return None
    if content[:1] in "[{":
        return None
    for i, ch in enumerate(content):
        if ch == ":" and content[i + 1:i + 2] in ("", " "):
            return content[:i].strip(), content[i + 1:].strip()
    return None


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """The block node starting at ``lines[i]`` (at ``indent``)."""
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        items = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].strip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    value, i = None, i + 1
            else:
                # "- key: value" opens a mapping indented past the dash.
                sub = [(indent + 2, rest)]
                j = i + 1
                while j < len(lines) and lines[j][0] > indent:
                    sub.append(lines[j])
                    j += 1
                value, _ = _block(sub, 0, indent + 2)
                i = j
            items.append(value)
        return items, i
    if _key_split(content) is not None:
        mapping: Dict[Any, Any] = {}
        while i < len(lines) and lines[i][0] == indent:
            split = _key_split(lines[i][1])
            if split is None:
                raise YamlError(f"expected 'key: value', got {lines[i][1]!r}")
            key, rest = split
            key = _node(key)
            if rest:
                value, i = _node(rest), i + 1
            elif i + 1 < len(lines) and (lines[i + 1][0] > indent or (
                    lines[i + 1][0] == indent and lines[i + 1][1].startswith("- "))):
                value, i = _block(lines, i + 1, lines[i + 1][0])
            else:
                value, i = None, i + 1
            mapping[key] = value
        if i < len(lines) and lines[i][0] > indent:
            raise YamlError(f"bad indentation at {lines[i][1]!r}")
        return mapping, i
    # A scalar that continues over more-indented lines (folded with spaces).
    parts, j = [content], i + 1
    while j < len(lines) and lines[j][0] > indent:
        parts.append(lines[j][1])
        j += 1
    return _node(" ".join(parts)), j


def loads(text: str) -> Any:
    """Parse one YAML document of the subset (see the module docstring)."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlError(f"unexpected text at {lines[i][1]!r}")
    return value


# --- the writer ----------------------------------------------------------------

_SPECIAL = set(":#,[]{}&*!|>'\"%@`")


def _scalar_text(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"  # PyYAML reads "1e-05" as a string
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text
    if isinstance(value, datetime.date):
        return value.isoformat()
    text = str(value)
    if (resolve_scalar(text) == text and text == text.strip() and text
            and not (_SPECIAL & set(text)) and not text.startswith(("-", "?"))):
        return text
    return "'" + text.replace("'", "''") + "'"


def _flow_text(value: Any) -> str:
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar_text(k)}: {_flow_text(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow_text(v) for v in value) + "]"
    return _scalar_text(value)


def dumps(data: Any, indent: int = 0) -> str:
    """YAML text that ``loads`` (and ``yaml.safe_load``) read back as
    ``data``: block mappings, lists and nested flow values in flow style."""
    pad = " " * indent
    if not isinstance(data, dict):
        return pad + _flow_text(data) + "\n"
    out = []
    for key, value in data.items():
        if isinstance(value, dict) and value:
            out.append(f"{pad}{_scalar_text(key)}:\n" + dumps(value, indent + 2))
        else:
            out.append(f"{pad}{_scalar_text(key)}: {_flow_text(value)}\n")
    return "".join(out)


# --- the configuration surface -------------------------------------------------


class ConfigDict(dict):
    """dict with attribute access and recursive wrapping (OmegaConf-lite)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)

    def to_yaml(self) -> str:
        return dumps(self.to_dict())


def _set_dotted(cfg: Dict, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _parse_value(raw: str) -> Any:
    """YAML-typed override value (null, true, [1,2], ...); text that is not
    YAML of the subset stays the raw string."""
    try:
        return loads(raw)
    except YamlError:
        return raw


def parse_overrides(tokens: Iterable[str]) -> Tuple[Dict[str, Any], Optional[str], Optional[str]]:
    """Split argv tokens into (overrides, config_name, config_path)."""
    overrides: Dict[str, Any] = {}
    config_name = None
    config_path = None
    toks = list(tokens)
    i = 0
    while i < len(toks):
        tok = toks[i]
        flag = tok.split("=", 1)[0]
        if flag in ("--config-name", "--config-path"):
            # Both --config-name=NAME and --config-name NAME; dropping the
            # space-separated value would run the default config.
            if "=" in tok:
                value = tok.split("=", 1)[1]
            elif i + 1 < len(toks) and "=" not in toks[i + 1]:
                i += 1
                value = toks[i]
            else:
                raise ValueError(f"{tok} requires a value "
                                 f"({tok}=NAME or '{tok} NAME')")
            if flag == "--config-name":
                config_name = value
            else:
                config_path = value
        elif "=" in tok and not tok.startswith("-"):
            key, raw = tok.split("=", 1)
            overrides[key.lstrip("+")] = _parse_value(raw)  # +key= appends
        elif tok.startswith("-"):
            # '--train.batch_size=128' is a likely slip: ignoring it would
            # run with the default value.
            raise ValueError(
                f"Unrecognized flag {tok!r}: overrides use Hydra style "
                f"(key=value, e.g. {tok.lstrip('-')}), not --flags")
        i += 1
    return overrides, config_name, config_path


def load_config(
    config_name: str = "config",
    config_path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> ConfigDict:
    """Load a YAML config and apply dotted overrides."""
    path_dir = config_path or _CONFIG_DIR
    name = config_name if config_name.endswith((".yaml", ".yml")) else config_name + ".yaml"
    with open(os.path.join(path_dir, name)) as f:
        cfg = loads(f.read()) or {}
    if overrides:
        for k, v in overrides.items():
            _set_dotted(cfg, k, v)
    return ConfigDict.wrap(cfg)


def load_config_from_argv(argv: List[str], default_name: str = "config") -> ConfigDict:
    """Hydra-style entry: parse argv into config + overrides."""
    overrides, name, path = parse_overrides(argv)
    return load_config(name or default_name, path, overrides)


def save_config(cfg: ConfigDict, run_dir: str) -> str:
    """Write the resolved config to ``<run_dir>/.hydra/config.yaml``."""
    out_dir = os.path.join(run_dir, ".hydra")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "config.yaml")
    with open(out, "w") as f:
        f.write(cfg.to_yaml())
    return out


def merge(base: ConfigDict, *updates: Dict) -> ConfigDict:
    """Deep-merge dicts into a copy of base."""
    out = copy.deepcopy(base.to_dict() if isinstance(base, ConfigDict) else base)

    def rec(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                rec(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    for u in updates:
        rec(out, u.to_dict() if isinstance(u, ConfigDict) else u)
    return ConfigDict.wrap(out)


def get_augmentations(cfg: ConfigDict) -> List[Dict[str, Any]]:
    """``cfg.dataloader.augmentations`` as the ordered list of enabled ops,
    ``[{"name": ..., "p": ..., **params}, ...]``."""
    aug_cfg = cfg.get("dataloader", {}).get("augmentations") or {}
    ops: List[Dict[str, Any]] = []
    for name, spec in aug_cfg.items():
        spec = dict(spec)
        if not spec.pop("use", False):
            continue
        ops.append({"name": name, **spec})
    return ops


def check_required_flags(required: Iterable[str], cfg: ConfigDict) -> None:
    """Raise if any required top-level config value is missing/None."""
    missing = [k for k in required if cfg.get(k) in (None, "None", "null")]
    if missing:
        raise ValueError(f"Missing required config values: {missing}")
