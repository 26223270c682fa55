from knnsvc_torch.models.hifigan.generator import (
    init_generator_params,
    generator_apply,
    synthesizer_mix_apply,
    synthesizer_f0_apply,
    synthesizer_original_apply,
    vocode,
)
from knnsvc_torch.models.hifigan.discriminator import (
    init_mpd_params,
    init_msd_params,
    mpd_apply,
    msd_apply,
)
from knnsvc_torch.models.hifigan.losses import (
    feature_loss,
    discriminator_loss,
    generator_loss,
)

__all__ = [
    "init_generator_params",
    "generator_apply",
    "synthesizer_mix_apply",
    "synthesizer_f0_apply",
    "synthesizer_original_apply",
    "vocode",
    "init_mpd_params",
    "init_msd_params",
    "mpd_apply",
    "msd_apply",
    "feature_loss",
    "discriminator_loss",
    "generator_loss",
]
