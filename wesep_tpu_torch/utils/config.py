"""Config + logging utilities (counterpart of wesep_tpu/utils/config.py).

A config is a dict, or a YAML path; `yaml` is imported only when a path or
an override needs parsing.
"""

import logging
import os
import random

import numpy as np
import torch

__all__ = ["parse_config_or_kwargs", "parse_override_args", "deep_update",
           "set_seed", "setup_logger", "table_row"]


def parse_config_or_kwargs(config, **kwargs) -> dict:
    """YAML path or dict, merged with kwargs (kwargs win)."""
    if isinstance(config, dict):
        base = dict(config)
    else:
        import yaml

        with open(config) as f:
            base = yaml.safe_load(f)
    return dict(base, **kwargs)


def parse_override_args(pairs) -> dict:
    """['a.b=1', 'c=x'] -> nested dict overrides with YAML-typed values."""
    out = {}
    if not pairs:
        return out
    import yaml

    for pair in pairs:
        key, _, value = pair.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return out


def deep_update(base: dict, override: dict) -> dict:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def set_seed(seed: int = 42):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def setup_logger(exp_dir: str, name: str = "train.log"):
    """File + console logger; rotates an old log to name.N."""
    os.makedirs(exp_dir, exist_ok=True)
    log_path = os.path.join(exp_dir, name)
    if os.path.exists(log_path):
        for n in range(100, 0, -1):
            src = log_path if n == 1 else f"{log_path}.{n - 1}"
            if os.path.exists(src):
                os.replace(src, f"{log_path}.{n}")
    logger = logging.getLogger(f"wesep_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s [%(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    fh = logging.FileHandler(log_path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    return logger


def table_row(values, width: int = 10) -> str:
    """One row of a fixed-width grid, for the train log."""
    cells = []
    for v in values:
        s = f"{v:.4g}" if isinstance(v, float) else str(v)
        cells.append(s[:width].center(width))
    return "| " + " | ".join(cells) + " |"
