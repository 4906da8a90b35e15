"""YAML config loading with ``inherit:`` chaining.

Own copy of ``mast3r_slam_tpu/utils/config.py`` (the port imports nothing of
the JAX package): the same loader, deep merge and reference-exact overrides.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path

import yaml


def _sci_float_loader() -> type[yaml.SafeLoader]:
    """SafeLoader that parses '1e-3'-style scalars as floats
    (mirrors utils/config.py:22-41)."""

    class Loader(yaml.SafeLoader):
        pass

    Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:
             [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return Loader


def merge_config(base: dict, child: dict) -> dict:
    """Deep-merge ``child`` on top of ``base``, child wins
    (mirrors utils/config.py:44)."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str | Path) -> dict:
    """Load a YAML config, resolving the ``inherit`` chain relative to the
    working directory (mirrors utils/config.py:55).  Unlike the JAX loader
    it installs no process-global copy."""
    with open(Path(path)) as f:
        cfg = yaml.load(f, Loader=_sci_float_loader()) or {}
    if "inherit" in cfg:
        cfg = merge_config(load_config(cfg.pop("inherit")), cfg)
    if cfg.get("reference_exact"):
        cfg = apply_reference_exact(cfg)
    return cfg


# The config values that restore reference-exact behaviour
# (mirrors utils/config.py:75-103).
REFERENCE_EXACT_OVERRIDES = {
    "matching": {
        "coarse_subsample": 1,
        "final_radius": 0,
        "coarse_radius": 0,
        "dilation_schedule": [],
        "lm_subsample": 0,
        "lm_table_subsample": 1,
        "occlusion_subsample": 1,
        "edge_query_subsample": 1,
    },
    "tracking": {
        "joint_ray_huber": False,
        "point_subsample": 1,
    },
    "local_opt": {
        "points_subsample": 1,
        "reuse_track_matches": False,
        "reuse_warp": False,
        "retrieval_edge_mode": "sym",
    },
}


def apply_reference_exact(cfg: dict) -> dict:
    """Overlay the reference-exact values on ``cfg``, returning a copy
    (mirrors utils/config.py:106)."""
    out = merge_config(cfg, REFERENCE_EXACT_OVERRIDES)
    out["reference_exact"] = True
    return out


def frontend_config(path: str | Path = "config/base.yaml") -> dict:
    """The configuration the ported frontend runs: ``path`` with the
    reference-exact ``matching`` block and the production ``tracking``
    block (joint ray Huber, so the GN kernel stays on the path)."""
    return merge_config(load_config(path),
                        {"matching": REFERENCE_EXACT_OVERRIDES["matching"]})
