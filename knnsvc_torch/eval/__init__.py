from knnsvc_torch.eval.metrics import (
    compute_measures,
    wer,
    cer,
    eer,
    numbers_to_words,
)

__all__ = ["compute_measures", "wer", "cer", "eer", "numbers_to_words"]
