"""The model code's sharding context, on one device.

The reference's model code annotates activations with *logical* axes
(``dp``, ``fsdp``, ``tp``, ``ep``, ``sp``, ``seq``) and its
``ShardCtx`` resolves them onto an XLA mesh.  The port runs its models
on one device, so :class:`ShardCtx` with ``mesh=None`` makes every
constraint the identity, as the reference's does.  The logical axes stay
on every :class:`~repro_torch.models.common.PSpec` as data, for the
sharded LM paths (ROADMAP item 13d: ``resolve``, ``abstract_params``
and a ``DeviceMesh`` behind this class).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

SHARDED_SLICE = ("the sharded LM paths are not ported yet (ROADMAP item "
                 "13d); pass mesh=None")


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carried through model code.  ``mesh=None`` is the only mesh the
    port runs: :meth:`constrain` then returns its input."""

    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(SHARDED_SLICE)

    def constrain(self, x: torch.Tensor, *logical: str | None
                  ) -> torch.Tensor:
        return x
