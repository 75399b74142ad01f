"""Hierarchical wildcard config: the ``omnetpp.ini`` tier re-created
(``fognetsimpp_tpu/config/ini.py``, copied for the port's builders).

The reference's config system (SURVEY.md §5 "config/flag system") selects
implementations and sweeps values with wildcard keys like
``**.ComputeBroker1.udpApp[*].MIPS = 1000``.  Here the same mechanics bind
to the batched world: dotted parameter paths, ``*`` matching within one
path segment and ``**`` across segments, **first matching line wins**
(OMNeT++ precedence: put specific keys above general ones).

Recognised paths:
  * ``scenario``               — builder name (``smoke``, ``wireless5``,
    ``example``, ...)
  * ``scenario.<kwarg>``       — builder keyword (e.g. ``scenario.horizon``)
  * ``spec.<field>``           — any :class:`WorldSpec` field override
  * ``fog.<i|*>.mips``         — per-fog MIPS (``**.ComputeBroker2...MIPS``)
  * ``user.<i|*>.send_interval`` — per-user publish interval
  * ``seed``                   — PRNG seed
  * ``output.dir`` / ``output.run_id`` — recorder destination

Values parse as OMNeT++ quantities: ``50ms`` → 0.05, ``2s`` → 2.0,
``true``/``false``, ints, floats, bare strings.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_UNITS = {
    "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 1.0, "mps": 1.0,
    "bps": 1.0, "kbps": 1e3, "Mbps": 1e6, "B": 1.0, "J": 1.0,
    "mW": 1e-3, "W": 1.0, "deg": 1.0,
}


def parse_value(raw: str):
    """'50ms' -> 0.05, 'true' -> True, '3' -> 3, '1.5' -> 1.5, else str."""
    v = raw.strip().strip('"')
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    m = re.fullmatch(r"([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*(\w+)?", v)
    if m:
        num, unit = m.group(1), m.group(2)
        if unit is None:
            f = float(num)
            return int(f) if f.is_integer() and "." not in num and "e" not in num.lower() else f
        if unit in _UNITS:
            return float(num) * _UNITS[unit]
    return v


def _pattern_to_regex(pat: str) -> re.Pattern:
    out = []
    i = 0
    while i < len(pat):
        if pat.startswith("**", i):
            out.append(".*")
            i += 2
        elif pat[i] == "*":
            out.append(r"[^.]*")
            i += 1
        else:
            out.append(re.escape(pat[i]))
            i += 1
    return re.compile("".join(out) + r"\Z")


class Config:
    """Ordered wildcard-pattern config; first matching line wins."""

    def __init__(self, entries: List[Tuple[str, object]]):
        self.entries = [(p, _pattern_to_regex(p), v) for p, v in entries]

    @classmethod
    def from_str(cls, text: str) -> "Config":
        entries: List[Tuple[str, object]] = []
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("["):  # [General]-style headers
                continue
            if "=" not in line:
                continue
            key, _, raw = line.partition("=")
            entries.append((key.strip(), parse_value(raw)))
        return cls(entries)

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_str(f.read())

    def lookup(self, path: str, default=None):
        for _, rx, v in self.entries:
            if rx.match(path):
                return v
        return default

    def matching(self, prefix: str) -> Dict[str, object]:
        """All literal keys under ``prefix.`` (for builder kwargs)."""
        out: Dict[str, object] = {}
        for pat, _, v in self.entries:
            if pat.startswith(prefix + ".") and "*" not in pat:
                out.setdefault(pat[len(prefix) + 1 :], v)
        return out


def scenario_builders():
    """Name → builder registry (the network-NED catalogue analog)."""
    from ..scenarios import example, smoke, wired_v1, wireless

    return {
        "smoke": smoke.build,
        "wired_v1": wired_v1.build,
        "example": example.build,
        "wireless": wireless.wireless,
        "wireless2": wireless.wireless2,
        "wireless3": wireless.wireless3,
        "wireless4": wireless.wireless4,
        "wireless5": wireless.wireless5,
        "paper": wireless.paper,
    }


def build_from_config(cfg: Config, seed: Optional[int] = None, device=None):
    """Construct ``(spec, state, net, bounds)`` from a :class:`Config`, on
    ``device`` (the card unless the caller names one).

    The scenario builder supplies the topology; ``spec.*`` keys override
    WorldSpec fields; ``fog.<i>.mips`` / ``user.<i>.send_interval`` rewrite
    the per-node arrays afterwards (the per-module wildcard tier).
    """
    import dataclasses

    import numpy as np
    import torch

    from ..spec import WorldSpec

    name = cfg.lookup("scenario", "smoke")
    builders = scenario_builders()
    if name not in builders:
        raise ValueError(f"unknown scenario {name!r} (have {sorted(builders)})")
    kwargs = cfg.matching("scenario")
    if seed is None:
        seed = int(cfg.lookup("seed", 0))
    kwargs.setdefault("seed", seed)

    # spec.* overrides whose fields the builder accepts directly
    spec_fields = {f.name for f in dataclasses.fields(WorldSpec)}
    for pat, _, v in cfg.entries:
        if pat.startswith("spec.") and "*" not in pat:
            field = pat[5:]
            if field not in spec_fields:
                raise ValueError(f"unknown WorldSpec field {field!r}")
            if field == "chaos_script":
                # ini values are scalars: the scripted-outage schedule
                # travels as one 'fog:t_down:t_up;...' string and is
                # normalised to the spec's hashable tuple form here
                from ..chaos.profiles import parse_script

                v = parse_script(v)
            kwargs.setdefault(field, v)

    try:
        spec, state, net, bounds = builders[name](device=device, **kwargs)
    except TypeError as e:
        msg = str(e)
        if "multiple values" in msg:
            # a spec.* override collided with a field the builder owns
            import inspect

            m = re.search(r"argument '(\w+)'", msg)
            field = m.group(1) if m else "?"
            sig = set(inspect.signature(builders[name]).parameters)
            hint = (
                f"set it via a scenario.{field} key instead"
                if field in sig
                else "this field is derived by the builder and is not "
                "overridable for this scenario"
            )
            raise ValueError(
                f"scenario {name!r} owns WorldSpec field {field!r}: {hint}"
            ) from e
        raise

    # per-node wildcard tier (first match wins per index)
    dev = state.t.device
    mips = state.fogs.mips.cpu().numpy().copy()
    changed = False
    for i in range(spec.n_fogs):
        v = cfg.lookup(f"fog.{i}.mips")
        if v is not None:
            mips[i] = float(v)
            changed = True
    if changed:
        from ..core.engine import prime_initial_advertisements

        state = state.replace(
            fogs=state.fogs.replace(
                mips=torch.from_numpy(mips).to(dev),
                pool_avail=torch.from_numpy(mips.copy()).to(dev),
            )
        )
        # the primed first-advertisement payloads carried the old MIPS
        state = prime_initial_advertisements(spec, state, net)
    si = state.users.send_interval.cpu().numpy().copy()
    changed = False
    for i in range(spec.n_users):
        v = cfg.lookup(f"user.{i}.send_interval")
        if v is not None:
            si[i] = float(v)
            changed = True
    if changed:
        if si.min() <= 0:
            raise ValueError(
                f"user send_interval override must be > 0, got {si.min():g}"
            )
        # the send budget (max_sends_per_user) was sized from the builder's
        # interval; a faster per-user rate would silently truncate there
        if spec.horizon / si.min() + 1 > spec.max_sends_per_user:
            raise ValueError(
                f"user send_interval override {si.min():g}s exceeds the "
                f"world's send budget (max_sends_per_user="
                f"{spec.max_sends_per_user}); also set "
                f"spec.send_interval = {si.min():g} (or a smaller "
                "scenario horizon) so capacity is sized for the fastest "
                "publisher"
            )
        state = state.replace(
            users=state.users.replace(send_interval=torch.from_numpy(si).to(dev))
        )
    return spec, state, net, bounds
