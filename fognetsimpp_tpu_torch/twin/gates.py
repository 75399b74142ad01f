"""Composition gates of the twin subsystem: the ``[TWIN-*]`` clauses.

Counterpart of ``fognetsimpp_tpu/twin/gates.py``, with the same clause
IDs and texts: every refusal the twin layer can raise leads with a stable
bracketed ID defined once here, and the CLI cites these functions instead
of re-wording them.
"""
from __future__ import annotations

from typing import Optional


def ingest_reject_reason(runner: str) -> Optional[str]:
    """Why live ingestion cannot ride the given production runner
    (``None`` = it can).

    The injection phase lands single-device chunk boundaries: the
    sharded runners would need a cross-shard scatter of the arrival
    batch plus per-replica queue demultiplexing.
    """
    if runner == "tp":
        return (
            "[TWIN-INGEST-TP] live ingestion lands arrivals at "
            "single-device chunk boundaries; the TP runner's sharded "
            "task table would need a cross-shard injection scatter — "
            "serve the twin unsharded (drop --tp) or run --tp without "
            "--ingest"
        )
    if runner == "fleet":
        return (
            "[TWIN-INGEST-FLEET] live ingestion feeds ONE live "
            "session; the fleet batches R independent replicas and "
            "has no per-replica arrival demultiplex — drop --replicas "
            "or --ingest"
        )
    return None


def ingest_needs_serve_error() -> str:
    """One-line error for ``--ingest``/``--replay-arrivals`` without the
    serving loop that owns the chunk boundaries."""
    return (
        "[TWIN-INGEST-SERVE] live ingestion drains at the serving "
        "loop's chunk boundaries; --ingest/--replay-arrivals need "
        "--serve PORT"
    )


def whatif_reject_reason(
    *, fleet: bool = False, promote: bool = True
) -> Optional[str]:
    """Why a what-if fork cannot be served (``None`` = it can).

    A TP chunk-boundary carry forks like any other once
    ``parallel.taskshard.unstamp_tp_carry`` re-describes it.
    """
    if fleet:
        return (
            "[TWIN-WHATIF-FLEET] what-if forks already vmap the live "
            "carry over the knob grid; layering that onto the fleet's "
            "replica batch would nest vmaps the runner does not "
            "compile — fork from a single live session (drop "
            "--replicas)"
        )
    if not promote:
        return (
            "[TWIN-WHATIF-STATIC] what-if grids ride the promoted "
            "DynSpec operand (one compiled program, K knob rows); the "
            "static-spec path (FNS_SPEC_PROMOTE=0) would compile per "
            "cell — re-enable promotion"
        )
    return None


def ingest_off_error() -> str:
    """One-line error for feeding a world whose ingest gate is off."""
    return (
        "[TWIN-INGEST-OFF] this world was built without the ingestion "
        "gate: injection is compiled out (the bit-exactness contract); "
        "rebuild with spec.ingest=True (--ingest)"
    )


def payload_error(detail: str) -> str:
    """One-line error for a malformed ingest payload (HTTP 400)."""
    return (
        f"[TWIN-PAYLOAD] malformed ingest payload: {detail}; expected "
        'JSON {"user": <int>, "mips": <number>} or '
        '{"rows": [[user, mips], ...]}'
    )


def front_reject_reason(runner: str) -> Optional[str]:
    """Why the multi-tenant front door cannot ride the given runner
    (``None`` = it can; ``"solo"`` = no serving endpoint at all)."""
    if runner == "tp":
        return (
            "[TWIN-FRONT-TP] the front door round-robins single-device "
            "tenant sessions through one shared program; the TP "
            "sharded chunk loop is a different executable per mesh — "
            "serve tenants unsharded (drop --tp)"
        )
    if runner == "fleet":
        return (
            "[TWIN-FRONT-FLEET] the front door multiplexes N "
            "INDEPENDENT live sessions (own carry, recorder, watchdog "
            "each); the fleet batches replicas of one spec inside one "
            "jitted call — drop --replicas/--mesh or --tenants"
        )
    if runner == "solo":
        return (
            "[TWIN-FRONT-SERVE] --tenants multiplexes live sessions "
            "behind one HTTP endpoint; it needs --serve PORT"
        )
    return None


def whatif_payload_error(detail: str) -> str:
    """One-line error for a malformed ``/whatif`` request (HTTP 400)."""
    return (
        f"[TWIN-WHATIF-PAYLOAD] malformed what-if payload: {detail}; "
        "expected "
        'JSON {"knobs": {"<promoted field>": [values...]}, '
        '"ticks": <int>}'
    )


def admission_error(label: str, capacity: int) -> str:
    """One-line error for tenant admission past the capacity bound."""
    return (
        f"[TWIN-CAP] front door at capacity ({capacity} tenant"
        f"{'s' if capacity != 1 else ''}): cannot admit {label!r}; "
        "evict a tenant or raise the admission bound (--tenant-cap)"
    )
