"""Matmul and conv FLOPs (2 x multiply-adds) of w2v-BERT 2.0's encoder from
its shapes, and the least time of its relative-key attention launches (the
attention kernel's full-bias entry) on an H100. Per layer over T frames, D
wide, FFN width F, P = left + right + 1 relative distances, depthwise
kernel K:

    two half-step FFNs          8 T D F
    Q, K, V and O projections   8 T D^2
    Q K^T and P V               4 T^2 D
    relative-key products       2 T D P      (q . E over every distance)
    convolution module          6 T D^2 + 2 T D K
                                (pointwise D -> 2D and D -> D, depthwise)

plus the frontend's projection, 2 T (2 n_mels) D, once. The fbank (float64
FFTs and mel filters), LayerNorms, softmax and the bias gather are left
out, so a share of the peak from these counts is a lower bound."""

from __future__ import annotations

from .bounds import attention_bound_ms


def layer_flops(w: dict, T: int) -> int:
    """One Conformer layer over T frames; w holds HF's config keys."""
    D, F, K = w["hidden_size"], w["intermediate_size"], w["conv_depthwise_kernel_size"]
    P = w["left_max_position_embeddings"] + w["right_max_position_embeddings"] + 1
    return 8 * T * D * F + 8 * T * D * D + 4 * T * T * D + 2 * T * D * P \
        + 6 * T * D * D + 2 * T * D * K


def encoder_flops(w: dict, n_layers: int, T: int) -> int:
    """The projection and `n_layers` layers over one chunk of T frames."""
    projection = 2 * T * w["num_mel_bins"] * w["stride"] * w["hidden_size"]
    return projection + n_layers * layer_flops(w, T)


def rel_attention_bound_ms(w: dict, T: int) -> tuple[float, str]:
    """One launch of the full-bias entry at T frames (counts/bounds.py's
    attention bound: 3 TF32 passes of both products; q, k, v, gate and out
    once, and the (H, T, T) bias read once)."""
    H = w["num_attention_heads"]
    return attention_bound_ms(H, T, w["hidden_size"] // H, passes=3, full=True)
