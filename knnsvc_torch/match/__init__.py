from knnsvc_torch.match.distance import cosine_distance
from knnsvc_torch.match.knn import knn_topk
from knnsvc_torch.match.f0_logic import (
    torch_median,
    masked_log_median,
    shift_f0_to_target_register,
    sort_by_f0_compatibility,
)
from knnsvc_torch.match.concat_cost import knn_with_concat_cost
from knnsvc_torch.match.quantized_pool import QuantizedPool, knn_topk_quantized, quantize_pool
from knnsvc_torch.match.smoothness import optimize_smoothness_weights
from knnsvc_torch.match.pipeline import match_at_inference_time, match_utterance
from knnsvc_torch.match.pool import SpeakerPool, build_speaker_pool, build_speaker_pool_cached

__all__ = [
    "cosine_distance",
    "knn_topk",
    "torch_median",
    "masked_log_median",
    "shift_f0_to_target_register",
    "sort_by_f0_compatibility",
    "knn_with_concat_cost",
    "QuantizedPool",
    "knn_topk_quantized",
    "quantize_pool",
    "optimize_smoothness_weights",
    "match_at_inference_time",
    "match_utterance",
    "SpeakerPool",
    "build_speaker_pool",
    "build_speaker_pool_cached",
]
