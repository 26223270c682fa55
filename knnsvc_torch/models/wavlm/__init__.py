from knnsvc_torch.models.wavlm.model import (
    frame_count,
    init_wavlm_params,
    wavlm_encode,
    wavlm_extract_layer,
    wavlm_extract_layer_bucketed,
    wavlm_extract_all_layers,
)

__all__ = [
    "frame_count",
    "init_wavlm_params",
    "wavlm_encode",
    "wavlm_extract_layer",
    "wavlm_extract_layer_bucketed",
    "wavlm_extract_all_layers",
]
