"""Named chaos profiles (the ``--chaos <profile>`` CLI surface) and the
scripted-schedule parser shared by the CLI and the config tier
(a copy of ``fognetsimpp_tpu/chaos/profiles.py``: host code only).

A profile is a dict of ``WorldSpec`` chaos-field overrides; the CLI
turns it into ``spec.*`` config lines (:func:`chaos_config_lines`) so
profiles compose with every other config tier (``--set`` overrides win,
first-match semantics of ``config/ini.py``).  An unknown profile name is
ONE actionable ValueError listing the catalogue — the ``--policy``
unknown-name convention.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

from ..spec import ChaosMode

#: The profile catalogue.  MTBF/MTTR are simulated seconds; committed
#: horizons are a few seconds, so these produce several outages per fog
#: per run without flat-lining the world.
PROFILES: Dict[str, Dict] = {
    # crash/recover churn, conservative: tasks bounce back and retry
    "light": dict(
        chaos=True, chaos_mode=int(ChaosMode.REOFFLOAD),
        chaos_mtbf_s=2.0, chaos_mttr_s=0.2, chaos_max_retries=4,
    ),
    # heavy churn, still lossless while any fog stays up
    "heavy": dict(
        chaos=True, chaos_mode=int(ChaosMode.REOFFLOAD),
        chaos_mtbf_s=0.5, chaos_mttr_s=0.25, chaos_max_retries=4,
    ),
    # hard failures: in-flight work on a crashed fog is lost
    "flaky": dict(
        chaos=True, chaos_mode=int(ChaosMode.LOSE),
        chaos_mtbf_s=0.5, chaos_mttr_s=0.15,
    ),
    # links only: periodic + bursty broker->fog RTT degradation, no
    # crashes — staleness without loss
    "degraded": dict(
        chaos=True, chaos_rtt_amp=1.0, chaos_rtt_period_s=0.5,
        chaos_rtt_burst_prob=0.05, chaos_rtt_burst_mult=5.0,
    ),
    # everything at once: churn + degradation (the hostile-world bench)
    "hostile": dict(
        chaos=True, chaos_mode=int(ChaosMode.REOFFLOAD),
        chaos_mtbf_s=0.5, chaos_mttr_s=0.2, chaos_max_retries=4,
        chaos_rtt_amp=0.5, chaos_rtt_period_s=0.5,
        chaos_rtt_burst_prob=0.02, chaos_rtt_burst_mult=4.0,
    ),
    # the master gate alone: scripted schedules / --set knobs drive it
    "scripted": dict(chaos=True),
}


def resolve_profile(name: str) -> Dict:
    """Profile dict for ``name`` — unknown names are one actionable
    line listing the catalogue, never a traceback."""
    key = str(name).strip().lower()
    if key not in PROFILES:
        raise ValueError(
            f"unknown chaos profile {name!r} "
            f"(have {', '.join(sorted(PROFILES))})"
        )
    return dict(PROFILES[key])


def parse_script(value) -> Tuple[Tuple[int, float, float], ...]:
    """Normalise a scripted-outage schedule to the spec's tuple form.

    Accepts the spec tuple itself, any sequence of (fog, t_down, t_up)
    triples (e.g. parsed JSON lists), or the compact string form
    ``"fog:t_down:t_up;fog:t_down:t_up"`` the config tier carries
    (ini values are scalars, so the schedule travels as one string).
    Malformed input raises one actionable ValueError.
    """
    if isinstance(value, str):
        entries = []
        for part in value.split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) != 3:
                raise ValueError(
                    f"chaos script entry {part!r} is not "
                    "'fog:t_down:t_up'"
                )
            entries.append(bits)
        value = entries
    out = []
    for ent in value:
        if not isinstance(ent, Sequence) or len(ent) != 3:
            raise ValueError(
                f"chaos script entries are (fog, t_down, t_up) triples, "
                f"got {ent!r}"
            )
        f, td, tu = ent
        try:
            out.append((int(f), float(td), float(tu)))
        except (TypeError, ValueError):
            raise ValueError(
                f"chaos script entry {ent!r} needs an int fog index and "
                "float down/up times"
            ) from None
    return tuple(out)


def load_script_file(path: str) -> Tuple[Tuple[int, float, float], ...]:
    """Load a scripted schedule from a JSON file (a list of
    ``[fog, t_down, t_up]`` triples) or the compact ``fog:td:tu;...``
    text form.  One actionable ValueError on anything else."""
    if not os.path.exists(path):
        raise ValueError(f"chaos script file not found: {path}")
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        data = text.strip()
    return parse_script(data)


def script_to_str(script) -> str:
    """The compact one-string encoding config lines carry."""
    return ";".join(f"{int(f)}:{td:g}:{tu:g}" for f, td, tu in script)


def chaos_config_lines(
    profile: str,
    seed: Optional[int] = None,
    mode: Optional[str] = None,
    script: Optional[Sequence] = None,
) -> list:
    """``spec.* = value`` config lines for a profile (+ overrides).

    The CLI prepends these BELOW explicit ``--set`` lines, so the
    first-match-wins config semantics let users refine any profile knob.
    """
    over = resolve_profile(profile)
    if seed is not None:
        over["chaos_seed"] = int(seed)
    if mode is not None:
        m = str(mode).strip().lower()
        try:
            over["chaos_mode"] = int(ChaosMode[m.upper()])
        except KeyError:
            raise ValueError(
                f"unknown chaos mode {mode!r} (have "
                + ", ".join(x.name.lower() for x in ChaosMode)
                + ")"
            ) from None
    lines = [f"spec.{k} = {str(v).lower() if isinstance(v, bool) else v}"
             for k, v in over.items()]
    if script:
        lines.append(
            f"spec.chaos_script = {script_to_str(parse_script(script))}"
        )
    return lines
