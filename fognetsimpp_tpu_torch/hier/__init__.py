"""Federated multi-broker hierarchy with broker-to-broker task migration
(``fognetsimpp_tpu/hier``)."""
from .federation import (  # noqa: F401
    default_ownership,
    hier_counters,
    hier_reject_reason,
    hier_summary,
    init_hier_state,
    stamp_ownership,
)
from ..state import HierState  # noqa: F401
