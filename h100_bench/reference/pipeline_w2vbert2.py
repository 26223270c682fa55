"""The plain reference of one pair conversion through w2v-BERT 2.0,
`KnnSvc.convert_pair(fast=True)` with device f0 and int16 uploads: the
pool build of pipeline.py at the configuration's feature layer, with the
encoder of w2vbert.py; the match, the vocoder and the file reading are
pipeline.py's own. Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PostOpt
from .f0_device import device_f0_tensor
from .pipeline import (CHUNK_SECONDS, HOP_LENGTH, MIN_CHUNK_SECONDS, SAMPLE_RATE,
                       build_vocoder, match, read_wav)
from .stft import linear_spectrogram
from .w2vbert import W2VBertReference

__all__ = ["build_encoder", "build_pool", "build_vocoder", "convert"]


def build_encoder(state: dict, cfg: dict, device, layer: int) -> W2VBertReference:
    """The encoder's first `layer` layers (the only ones a layer-`layer`
    encode runs); cfg holds HF's config.json keys."""
    return W2VBertReference(state, cfg, layer, device)


@torch.no_grad()
def build_pool(wav: np.ndarray, encoder: W2VBertReference, device):
    """30-s chunks (each padded by the reference's hop quirk and uploaded as
    int16 codes), the features at the encoder's last layer, the linear
    spectrogram rows aligned to them, and device f0 per chunk -> (features
    (T, D), spec (T, 200), f0 (T,))."""
    feats, specs, f0s = [], [], []
    chunk_len = CHUNK_SECONDS * SAMPLE_RATE
    for index, start in enumerate(range(0, len(wav), chunk_len)):
        chunk = wav[start:start + chunk_len]
        if len(chunk) <= MIN_CHUNK_SECONDS * SAMPLE_RATE:
            break
        chunk = np.pad(chunk, (0, HOP_LENGTH - (len(chunk) % HOP_LENGTH)))
        codes = np.clip(np.round(chunk * 32768.0), -32768, 32767).astype(np.int16)
        x = torch.from_numpy(codes).to(device)[None].float() / 32768
        f = encoder.extract_layer(x, output_layer=encoder.n_layers)[0]
        spec = linear_spectrogram(x[0])
        off = min(index, spec.shape[0] - f.shape[0])
        feats.append(f)
        specs.append(spec[off:off + f.shape[0]])
        f0s.append(device_f0_tensor(x[0], SAMPLE_RATE, n_frames=f.shape[0]))
    feats = torch.cat(feats)
    return feats, torch.cat(specs), torch.cat(f0s)[:feats.shape[0]]


@torch.no_grad()
def convert(src_path: str, tgt_path: str, encoder: W2VBertReference, vocoder, ckpt_type: str,
            post_opt: str, topk: int, device) -> dict[str, torch.Tensor]:
    """One request, every stage's result: the features and f0 of both pools,
    the matched features, the float waveform and its int16 codes."""
    src_feats, _, src_f0 = build_pool(read_wav(src_path), encoder, device)
    tgt_feats, tgt_spec, tgt_f0 = build_pool(read_wav(tgt_path), encoder, device)
    out, shifted, harm = match(src_feats, src_f0, tgt_feats, tgt_spec, tgt_f0, ckpt_type,
                               PostOpt.parse(post_opt), topk)
    wav = vocoder(out[None], shifted.reshape(1, -1, 1),
                  None if harm is None else harm[None])[0]
    codes = torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(torch.int16)
    return {"src_feats": src_feats, "tgt_feats": tgt_feats, "src_f0": src_f0,
            "tgt_f0": tgt_f0, "out": out, "harm": harm, "wave": wav, "codes": codes}
