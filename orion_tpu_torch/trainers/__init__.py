"""Trainers of the port: the sync GRPO loop."""

from orion_tpu_torch.trainers.base import (BaseTrainer,  # noqa: F401
                                           make_optimizer, make_schedule)
from orion_tpu_torch.trainers.grpo import GRPOTrainer  # noqa: F401
