"""Pure compute ops (``zdcsim/ops``'s public names): channel sums,
Wasserstein metrics, the GAN and MoE losses and the routing functions. The
hand-written kernels and their plain versions are the modules
``decode_kernels``, ``fused_decode_kernels`` and ``epilogue_kernels``."""

from zdcsim_torch.ops.channels import (  # noqa: F401
    channel_basis, get_channel_masks, sum_channels, sum_channels_np,
)
from zdcsim_torch.ops.losses import (  # noqa: F401
    adaptive_load_balancing_loss, alb_annealing_weight, differentiation_loss,
    expert_distribution_loss, expert_utilization_entropy, hinge_discriminator_loss,
    hinge_generator_loss, intensity_regularization, log_cosh_loss, masked_mean, masked_std,
    sdi_gan_regularization, tau_schedule,
)
from zdcsim_torch.ops.routing import gumbel_softmax, straight_through_gates  # noqa: F401
from zdcsim_torch.ops.ws import wasserstein_1d, wasserstein_per_channel  # noqa: F401
