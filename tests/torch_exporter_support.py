"""Shared worlds of the exporter test files (no tests here).

Each world is run once by JAX and once by the port, on the CPU, from the
same scenario keywords: ``run_pair(name)`` returns ``(jax_spec,
jax_final, port_spec, port_final)``.  The worlds are small (a few users
and fogs, tens to a few hundred ticks) and cover the exporters' branches:
plane 1 with the latency histogram and journeys, chaos, the broker
hierarchy, a replica batch and a 2-shard TP run.
"""
import re

import jax

from fognetsimpp_tpu.hier import federation as jfed
from fognetsimpp_tpu.parallel import make_mesh
from fognetsimpp_tpu.parallel import replicas as jrep
from fognetsimpp_tpu.parallel import taskshard as jts
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.hier import federation as tfed
from fognetsimpp_tpu_torch.parallel import replicas as trep
from fognetsimpp_tpu_torch.parallel import taskshard as tts
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke

#: Plane 1, the histogram and 8 journeys on fast fogs (acks land early).
TELEMETRY = dict(n_users=16, n_fogs=3, fog_mips=(100000.0,), send_interval=0.01,
                 horizon=0.2, telemetry=True, telemetry_hist=True,
                 telemetry_journeys=8, derive_acks=False)
#: Random and scripted outages with the RTT wave, plane 1 on.
CHAOS = dict(n_users=8, n_fogs=3, send_interval=0.01, horizon=0.2,
             assume_static=False, chaos=True, chaos_mode=1, chaos_mtbf_s=0.05,
             chaos_mttr_s=0.02, chaos_script=((1, 0.05, 0.1),), chaos_rtt_amp=0.5,
             telemetry=True, telemetry_hist=True, derive_acks=False)
#: Two broker domains with forced migration, plane 1 on.
HIER = dict(n_users=4, n_fogs=4, fog_mips=(900.0, 60000.0), send_interval=0.02,
            horizon=0.25, n_brokers=2, hier_policy=1, hier_threshold=0.5,
            telemetry=True)
HIER_OWNERS = dict(user_broker=[0] * 4, fog_broker=[0, 1, 1, 1])
#: Four replicas of a smaller telemetry world.
REPLICAS = dict(TELEMETRY, n_users=8, horizon=0.05)
N_REPLICAS = 4
#: Two shards, the ring bounded at two candidates a shard (deferrals).
TP = dict(n_users=16, n_fogs=3, send_interval=0.01, horizon=0.2,
          start_time_max=0.05, fog_mips=(100000.0,), telemetry=True,
          telemetry_hist=True, telemetry_journeys=16, telemetry_journey_ring=16)
TP_SHARDS = 2
TP_TICKS = 40
TP_WINDOW = 2

WORLDS = ("telemetry", "chaos", "hier", "replicas", "tp")

_CACHE = {}


def _single(kw, owners=None):
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    js, jst, jn, jb = jsmoke.build(**kw)
    if owners is not None:
        st = tfed.stamp_ownership(spec, st, **owners)
        jst = jfed.stamp_ownership(js, jst, **owners)
    final, _ = tengine.run(spec, st, net, b)
    jfinal, _ = jengine.run(js, jst, jn, jb)
    return js, jfinal, spec, final


def run_pair(name):
    """``(jax_spec, jax_final, port_spec, port_final)`` of a world of
    :data:`WORLDS`, run once a process."""
    if name in _CACHE:
        return _CACHE[name]
    if name == "telemetry":
        out = _single(TELEMETRY)
    elif name == "chaos":
        out = _single(CHAOS)
    elif name == "hier":
        out = _single(HIER, HIER_OWNERS)
    elif name == "replicas":
        spec, st, net, b = tsmoke.build(device="cpu", **REPLICAS)
        js, jst, jn, jb = jsmoke.build(**REPLICAS)
        final = trep.run_replicated(spec, trep.replicate_state(spec, st, N_REPLICAS), net, b)
        jfinal = jrep.run_replicated(js, jrep.replicate_state(js, jst, N_REPLICAS), jn, jb)
        out = (js, jfinal, spec, final)
    elif name == "tp":
        spec, st, net, b = tsmoke.build(device="cpu", **TP)
        js, jst, jn, jb = jsmoke.build(**TP)
        spec2, final = tts.run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS,
                                          n_ticks=TP_TICKS, exchange_window=TP_WINDOW)
        js2, jfinal = jts.run_tp_sharded(js, jst, jn, jb, make_mesh(TP_SHARDS, axis_name="node"),
                                         n_ticks=TP_TICKS, exchange_window=TP_WINDOW)
        out = (js2, jax.device_get(jfinal), spec2, final)
    else:
        raise KeyError(name)
    _CACHE[name] = out
    return out


_COMPILE = re.compile(r"^(# (HELP|TYPE) )?fns_compile_")


def without_compile_families(text):
    """JAX's exposition less its ``fns_compile_*`` families (XLA's program
    cache, which the port does not render, by design)."""
    return "".join(ln for ln in text.splitlines(keepends=True) if not _COMPILE.match(ln))
