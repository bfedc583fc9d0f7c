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

# the counters of the kernel wrappers: every launch, and the launches that
# ran on the tensor cores (B, D), in clusters of the plan's k (A, C, G, H)
# or on the bulk ring (E, F)
COUNTERS = ("launches", "mma_launches", "cluster_launches", "bulk_launches")


def kernel_wrappers():
    """``{name: wrapper}`` of every kernel wrapper that a serving path
    launches (A-D, G, H, E, F), each with its :data:`COUNTERS`. The stage
    wrappers ``fused_conv_int8`` and ``fused_norm_stage`` are left out:
    nothing on a serving path calls them."""
    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import epilogue_kernels as ek
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    return {"ln_leaky_rowquant": dk.ln_leaky_rowquant, "up2_conv4_int8": dk.up2_conv4_int8,
            "gn_leaky_rowquant": dk.gn_leaky_rowquant,
            "row_resize_conv4_int8": dk.row_resize_conv4_int8,
            "fused_decode_front": fdk.fused_decode_front, "fused_decode": fdk.fused_decode,
            "expm1_channel_sums": ek.expm1_channel_sums,
            "routed_expm1_channel_sums": ek.routed_expm1_channel_sums}
