"""RL algorithm math of the port (``orion_tpu/algos``): advantages, KL
estimators and the clipped policy loss the GRPO trainer reads."""

from orion_tpu_torch.algos.advantages import (grpo_advantages,  # noqa: F401
                                              masked_mean, masked_whiten)
from orion_tpu_torch.algos.kl import kl_penalty  # noqa: F401
from orion_tpu_torch.algos.losses import ppo_policy_loss  # noqa: F401
