"""CLI-flag / YAML-config to env-var translation.

Copied from ``horovod_tpu/runner/config_parser.py`` (reference parity:
horovod/runner/common/util/config_parser.py): three equivalent layers —
env vars, CLI flags, --config-file YAML — all converging on env vars
read at init.  Knob names keep the reference's spelling so existing
horovodrun config files translate 1:1.  Knobs of the JAX package's
native controller (cycle time, cache, timeline, stall checks) pass
through to the workers' environment; the port has no native controller
yet and reads none of them.
"""

from __future__ import annotations

from typing import Dict, Optional

# flag/yaml key -> env suffix (HVD_TPU_<suffix>); mirrors the reference's
# _add_arg set in runner/launch.py + config_parser constants.
_KNOBS = {
    "fusion_threshold": "FUSION_THRESHOLD",
    "cycle_time_ms": "CYCLE_TIME",
    "cache_capacity": "CACHE_CAPACITY",
    "timeline_filename": "TIMELINE",
    "timeline_mark_cycles": "TIMELINE_MARK_CYCLES",
    "stall_check_disable": "STALL_CHECK_DISABLE",
    "stall_warning_time_seconds": "STALL_CHECK_TIME_SECONDS",
    "stall_shutdown_time_seconds": "STALL_SHUTDOWN_TIME_SECONDS",
    "autotune": "AUTOTUNE",
    "autotune_log": "AUTOTUNE_LOG",
    "hierarchical_allreduce": "HIERARCHICAL_ALLREDUCE",
    "log_level": "LOG_LEVEL",
    "elastic": "ELASTIC",
}


def config_to_env(args, config_file: Optional[dict] = None) -> Dict[str, str]:
    """Build the HVD_TPU_* env block for workers from parsed CLI args and
    an optional YAML config dict (CLI wins, matching the reference's
    precedence)."""
    env: Dict[str, str] = {}
    merged = dict(config_file or {})
    for key in _KNOBS:
        val = getattr(args, key, None)
        if val is None and key in merged:
            val = merged[key]
        if val is None:
            continue
        if isinstance(val, bool):
            val = "1" if val else "0"
        env[f"HVD_TPU_{_KNOBS[key]}"] = str(val)
    return env


def load_config_file(path: str) -> dict:
    """Reference: --config-file YAML (runner/launch.py)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must contain a mapping")
    return data
