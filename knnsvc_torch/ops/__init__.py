from knnsvc_torch.ops.attention import gated_bias_attention

__all__ = ["gated_bias_attention"]
