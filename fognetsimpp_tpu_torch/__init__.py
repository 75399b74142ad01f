"""PyTorch/CUDA port of fognetsimpp_tpu (see README, "PyTorch port").

The package's public names are the JAX package's: the spec enums and
name parsers, the world state, the tick and its runners, and the
promoted-knob helpers, each from the port's own modules.  Importing it
builds no kernel: the CUDA sources compile at their first launch.
"""
from .spec import (  # noqa: F401
    ARGMIN_FAMILY,
    LEARNED_POLICIES,
    BugCompat,
    FogModel,
    HierPolicy,
    Mobility,
    NodeKind,
    Policy,
    Stage,
    WorldSpec,
    hier_policy_from_name,
    policy_from_name,
)
from .state import WorldState, init_state  # noqa: F401
from .core.engine import (  # noqa: F401
    make_step,
    prime_initial_advertisements,
    run,
    run_chunked,
    run_jit,
)
from .dynspec import (  # noqa: F401
    DYN_FIELDS,
    DynSpec,
    apply_knobs,
    bucket_spec,
    bucket_users,
    dyn_of,
    shape_key,
    split_spec,
)

__version__ = "0.1.0"
