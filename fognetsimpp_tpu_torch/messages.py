"""The typed protocol-message layer: all 12 reference schemas, mapped
(``fognetsimpp_tpu/messages.py``, copied for the port's states).

The reference declares 9 MQTT + 3 fognet packet types as OMNeT++ ``.msg``
schemas (``src/mqttapp/{mqttMessages,fognetMessages}/*.msg``) compiled by
nedtool into ~5.5k LoC of serialization code (SURVEY.md §2.1).  The batched
engine carries the same information as *columns of dense arrays* — a
message "in flight" is a set of per-task/per-node timestamps and payload
fields rather than a heap object.  This module is the explicit schema map:
for every reference message type, which array fields realise its payload
and which engine phase plays each side of the exchange.  It exists so
parity auditing is a table lookup, and so message-level accounting
(:func:`message_counts`) has one authoritative source.

Schema notes mirrored from the reference:
  * Publish **carries the task** (``MqttMsgPublish.msg:21-29``): clientID,
    topic, MIPSRequired, requiredTime, messageID.
  * PingRequest/PingResponse are declared but never sent by any app (no
    references in any ``.cc``) — they exist here as DEAD entries for
    inventory completeness.
  * TaskAck (``FognetMsgTaskAck.msg:17-20``) is v1/v2 only, and every
    broker generation ignores it (``BrokerBaseApp2.cc:139-141``) — realised
    as :class:`~.spec.Stage` REJECTED with no client ack.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple

import numpy as np

from .spec import WorldSpec
from .state import WorldState


class Direction(enum.Enum):
    USER_TO_BROKER = "user->broker"
    BROKER_TO_USER = "broker->user"
    FOG_TO_BROKER = "fog->broker"
    BROKER_TO_FOG = "broker->fog"


@dataclasses.dataclass(frozen=True)
class MessageSchema:
    """One reference ``.msg`` type and its array realisation."""

    name: str  # reference class name
    msg_file: str  # schema file under src/mqttapp/
    direction: Direction
    payload: Tuple[str, ...]  # reference payload fields
    realised_by: str  # engine state/phase that carries it
    live: bool = True  # False = declared but never sent in the reference


SCHEMAS: Dict[str, MessageSchema] = {
    s.name: s
    for s in [
        MessageSchema(
            "MqttMsgConnect", "mqttMessages/MqttMsgConnect.msg:28-67",
            Direction.USER_TO_BROKER,
            ("clientID", "qos", "isBroker", "will", "cleanSession",
             "keepAlive"),
            "users.start_t -> _phase_connect (pending mask); fog Connects "
            "are broker.register_t (prime_initial_advertisements)",
        ),
        MessageSchema(
            "MqttMsgConnack", "mqttMessages/MqttMsgConnack.msg",
            Direction.BROKER_TO_USER, ("returnCode",),
            "users.connack_at; first publish fires on arrival "
            "(_phase_connect)",
        ),
        MessageSchema(
            "MqttMsgSubscribe", "mqttMessages/MqttMsgSubscribe.msg:21-25",
            Direction.USER_TO_BROKER, ("clientID", "topic", "qos"),
            "users.sub_mask rows (the broker's subscriptions[] transposed); "
            "counted on Connack in _phase_connect",
        ),
        MessageSchema(
            "MqttMsgSuback", "mqttMessages/MqttMsgSuback.msg",
            Direction.BROKER_TO_USER, ("returnCode",),
            "metrics.n_subscribed increment in _phase_connect",
        ),
        MessageSchema(
            "MqttMsgPublish", "mqttMessages/MqttMsgPublish.msg:21-29",
            Direction.USER_TO_BROKER,
            ("clientID", "topic", "mqttMessage", "qoS", "MIPSRequired",
             "requiredTime", "messageID"),
            "TaskState row (slot = user * max_sends + send_idx): topic, "
            "mips_req, t_create, t_at_broker (_phase_spawn)",
        ),
        MessageSchema(
            "MqttMsgPuback", "mqttMessages/MqttMsgPuback.msg:24-28",
            Direction.BROKER_TO_USER, ("qos", "messageID", "status"),
            "the ack-time columns: t_ack3 (v1 local accept), t_ack4_fwd "
            "(forwarded), t_ack4_queued, t_ack5 (assigned), t_ack6 "
            "(performed) — statuses 3/4/5/6 of the reference chain",
        ),
        MessageSchema(
            "MqttMsgPingRequest", "mqttMessages/MqttMsgPingRequest.msg",
            Direction.USER_TO_BROKER, (), "none — dead in the reference",
            live=False,
        ),
        MessageSchema(
            "MqttMsgPingResponse", "mqttMessages/MqttMsgPingResponse.msg",
            Direction.BROKER_TO_USER, (), "none — dead in the reference",
            live=False,
        ),
        MessageSchema(
            "MqttMsgBase", "mqttMessages/MqttMsgBase.msg",
            Direction.USER_TO_BROKER, ("messageType", "qos"),
            "abstract base — the Stage/ack-column encodings stand in for "
            "messageType",
        ),
        MessageSchema(
            "FognetMsgAdvertiseMIPS",
            "fognetMessages/FognetMsgAdvertiseMIPS.msg:22-26",
            Direction.FOG_TO_BROKER, ("MIPS", "computeBrokerID", "busyTime"),
            "BrokerView.adv_val_mips/adv_val_busy/adv_arrive_t (latest-wins "
            "in-flight slot); applied by _phase_adverts",
        ),
        MessageSchema(
            "FognetMsgTask", "fognetMessages/FognetMsgTask.msg:22-27",
            Direction.BROKER_TO_FOG,
            ("requestID", "requiredTime", "clientID", "requiredMIPS"),
            "TaskState.fog + t_at_fog set by _phase_broker; consumed by "
            "_phase_fog_arrivals / _phase_pool_arrivals",
        ),
        MessageSchema(
            "FognetMsgTaskAck", "fognetMessages/FognetMsgTaskAck.msg:17-20",
            Direction.FOG_TO_BROKER, ("requestID", "status"),
            "v1/v2 pool reject -> Stage.REJECTED (broker ignores it, so no "
            "client ack column)",
        ),
    ]
}


def live_schemas() -> Dict[str, MessageSchema]:
    return {k: v for k, v in SCHEMAS.items() if v.live}


def message_counts(spec: WorldSpec, final: WorldState) -> Dict[str, int]:
    """Per-type message totals reconstructed from a finished run.

    The authoritative wire-level accounting (what the reference's
    ``sentPk``/``rcvdPk`` scalars count per app) derived from the task
    table and control-plane state.
    """
    from .runtime.recorder import to_host

    final = to_host(final)
    t = final.tasks
    fin = lambda col: int(np.isfinite(np.asarray(col)).sum())  # noqa: E731
    n_connect = int(np.asarray(final.users.connected).sum()) + spec.n_fogs
    n_sub = int(np.asarray(final.metrics.n_subscribed))
    pubacks = sum(
        fin(c) for c in (t.t_ack3, t.t_ack4_fwd, t.t_ack4_queued, t.t_ack5,
                         t.t_ack6)
    )
    return {
        "MqttMsgConnect": n_connect,
        "MqttMsgConnack": n_connect,
        "MqttMsgSubscribe": n_sub,
        "MqttMsgSuback": n_sub,
        "MqttMsgPublish": int(np.asarray(final.metrics.n_published)),
        "MqttMsgPuback": pubacks,
        "FognetMsgAdvertiseMIPS": int(np.asarray(final.metrics.n_adverts)),
        "FognetMsgTask": int(np.asarray(final.metrics.n_scheduled)),
        "FognetMsgTaskAck": int(np.asarray(final.metrics.n_rejected)),
        "MqttMsgPingRequest": 0,
        "MqttMsgPingResponse": 0,
    }
