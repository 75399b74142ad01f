"""Deterministic fault injection (``fognetsimpp_tpu/chaos``): fog
crash/recover schedules, in-flight loss or re-offload, and broker->fog
link degradation.

``faults.py`` holds the schedule kernels and the host readers,
``profiles.py`` the profile catalogue and the script parser; the engine
phase that applies them is ``core/engine._phase_chaos``.
"""
from .faults import (  # noqa: F401
    chaos_counters,
    chaos_summary,
    init_chaos_state,
    outage_timeline,
    refold_chaos_state,
    rtt_factor,
    step_lifecycle,
)
from .profiles import PROFILES, chaos_config_lines, parse_script  # noqa: F401
from ..state import ChaosState  # noqa: F401
