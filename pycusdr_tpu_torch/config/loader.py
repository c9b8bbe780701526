"""Modular JSON-with-comments config loader (a copy of
``pycusdr_tpu/config/loader.py``).

Capability parity with the reference's external ``pyLoadModularJson`` +
``rjsmin`` dependency (used at ``pyCuSDR/pyCuSDR.py:61``; hierarchical
includes via the ``"configBase"`` key, e.g. ``config/CC11xx.json:7``):

* ``//`` line comments and ``/* */`` block comments are stripped,
* a top-level ``"configBase": "relative/path.json"`` key chains to a
  parent config (recursively); child keys override parent keys with a
  deep (per-key) dictionary merge.
"""

import json
import os
from typing import Any, Dict


def strip_json_comments(text: str) -> str:
    """Remove // and /* */ comments from JSON text (string-literal aware)."""
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:  # escaped char inside string
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge: override wins; dicts merge recursively, others replace."""
    merged = dict(base)
    for key, val in override.items():
        if key in merged and isinstance(merged[key], dict) and isinstance(val, dict):
            merged[key] = merge_configs(merged[key], val)
        else:
            merged[key] = val
    return merged


def load_modular_json(path: str, _seen=None) -> Dict[str, Any]:
    """Load a JSON config, following ``configBase`` includes recursively."""
    path = os.path.abspath(path)
    _seen = set(_seen or ())
    if path in _seen:
        raise ValueError(f"Circular configBase include detected at {path}")
    _seen.add(path)

    with open(path, "r") as f:
        cfg = json.loads(strip_json_comments(f.read()))

    base_ref = cfg.pop("configBase", None)
    if base_ref is not None:
        base_path = os.path.join(os.path.dirname(path), base_ref)
        base_cfg = load_modular_json(base_path, _seen)
        cfg = merge_configs(base_cfg, cfg)
    return cfg
