"""Parallelism of the port: sequence parallelism over a ring of shards
(``longctx``)."""

from orion_tpu_torch.parallel.longctx import (StackedRing, ring_attention,
                                              ring_attention_reference,
                                              sequence_parallel,
                                              ulysses_attention,
                                              zigzag_inverse, zigzag_order)

__all__ = ["StackedRing", "ring_attention", "ring_attention_reference",
           "sequence_parallel", "ulysses_attention", "zigzag_inverse",
           "zigzag_order"]
