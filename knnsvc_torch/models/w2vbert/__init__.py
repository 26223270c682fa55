from knnsvc_torch.models.w2vbert.model import (
    W2VBert,
    init_w2vbert_params,
    w2vbert_from_state_dict,
)

__all__ = ["W2VBert", "init_w2vbert_params", "w2vbert_from_state_dict"]
