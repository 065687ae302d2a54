"""Replica lifecycle states that the autoscalers and the fleet simulator
report in.

Counterpart of ``ReplicaStatus`` in skypilot_tpu/serve/serve_state.py:
the enum, its scale-down preference order and its terminal set.  The
service and replica tables there are orchestration and are not part of
the port.
"""
from __future__ import annotations

import enum
from typing import List


class ReplicaStatus(enum.Enum):
    """Replica lifecycle."""
    PENDING = 'PENDING'
    PROVISIONING = 'PROVISIONING'
    STARTING = 'STARTING'            # provisioned; within initial delay
    READY = 'READY'
    NOT_READY = 'NOT_READY'          # probe failing, not yet failed over
    SHUTTING_DOWN = 'SHUTTING_DOWN'
    FAILED = 'FAILED'
    FAILED_INITIAL_DELAY = 'FAILED_INITIAL_DELAY'
    FAILED_PROBING = 'FAILED_PROBING'
    FAILED_PROVISION = 'FAILED_PROVISION'
    PREEMPTED = 'PREEMPTED'

    def is_terminal(self) -> bool:
        return self in _TERMINAL_REPLICA_STATUSES

    def is_failed(self) -> bool:
        return self in (ReplicaStatus.FAILED,
                        ReplicaStatus.FAILED_INITIAL_DELAY,
                        ReplicaStatus.FAILED_PROBING,
                        ReplicaStatus.FAILED_PROVISION)

    @classmethod
    def scale_down_decision_order(cls) -> List['ReplicaStatus']:
        """Preference order when choosing replicas to kill (the least
        useful first)."""
        return [cls.PENDING, cls.PROVISIONING, cls.STARTING, cls.NOT_READY,
                cls.READY]


_TERMINAL_REPLICA_STATUSES = frozenset({
    ReplicaStatus.FAILED, ReplicaStatus.FAILED_INITIAL_DELAY,
    ReplicaStatus.FAILED_PROBING, ReplicaStatus.FAILED_PROVISION,
    ReplicaStatus.PREEMPTED, ReplicaStatus.SHUTTING_DOWN,
})
