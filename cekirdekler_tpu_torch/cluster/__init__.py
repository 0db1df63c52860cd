"""Cluster tier: multi-host compute (reference L6, SURVEY.md §2.1 #11-16).

The port's copy of the reference's cluster package; it never imports the
JAX package.  Two tiers share the :class:`IComputeNode` surface:

- **DCN tier** — :class:`DistributedAccelerator` (dcn.py): the same
  ``compute()`` spanning the processes of a ``torch.distributed`` job,
  balanced in LCM-step units, written ranges exchanged with gloo
  collectives on host bytes.
- **TCP tier** — :class:`ClusterAccelerator` driving
  :class:`CruncherServer` nodes through the :class:`CruncherClient` wire
  protocol (byte for byte the reference's): explicit node orchestration
  for ad-hoc fleets, with mid-compute failover and probes.

``elastic.py`` adds epoch-numbered membership, heartbeats and per-window
checkpoints (preemption-shaped elasticity).
"""

from .accelerator import ClusterAccelerator, IComputeNode
from .balancer import ClusterLoadBalancer
from .client import CruncherClient
from .dcn import DistributedAccelerator
from .netbuffer import ArrayRecord, Command, Message, recv_message, send_message
from .server import CruncherServer

__all__ = [
    "ArrayRecord",
    "ClusterAccelerator",
    "ClusterLoadBalancer",
    "Command",
    "CruncherClient",
    "CruncherServer",
    "DistributedAccelerator",
    "IComputeNode",
    "Message",
    "recv_message",
    "send_message",
]
