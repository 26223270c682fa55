"""Model wrapper + factory (counterpart of knnsvc_tpu/hub.py::KnnSvc; the
reference's KNeighborsVC / ddsp_hubconf surface, ref ddsp_matcher.py:303-1156).

Ported: the constructor, `random_init`, `load` for `.knnsvc.pkl` payloads
and the reference's torch `.pt` checkpoints, the `knn_vc` factory;
`convert_pair(fast=True)` — the single-pair serving path for every model
family (MIX, F0_ONLY, ORIGINAL), with or without post_opt (concat-cost
reselection and the smoothness optimizer), host or device f0, float32 or
int16 uploads, WAV or FLAC files and optional loudness normalization;
`convert_pair(fast=False)` — the host-pool path (ref special_match);
`bulk_convert` — dataset to dataset (ref bulk_match): the host loop and the
device-resident fast loops, serial or `data_batch` at a time; and the
legacy knn-vc surface (`get_features`, `get_matching_set`, `get_f0`,
`vocode`, `vocode_batch`, `match`, `self_match`); streaming conversion
(`stream_convert_chunks`, `stream_convert`, `stream_session` and its
`StreamSession`), with the windowed or the cached (K/V-cache) encoder; the
multi-device matchers 'sharded' and 'sharded_int8' on every one of these
paths, the target pool split over the pool axis of `mesh=` (a
parallel.Mesh; default: every card, or the CPU, as one pool axis), and a
mesh's data axis splitting `bulk_convert`'s batched loop. On one card a
mesh of repeated devices (make_mesh(devices=[cuda:0] * 4, n_pool=4)) runs
the multi-shard code as logical shards. `mel_vocode` (a debug path)
vocodes a waveform's log-mel. Everything runs on device="cuda" unless the
caller passes device="cpu".
"""

from __future__ import annotations

import collections
import csv
import glob
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch import HOP_LENGTH
from knnsvc_torch.config import (HiFiGANConfig, PostOpt, W2VBertConfig, WavLMConfig,
                                 model_family_for_ckpt_type, uses_harmonics)
from knnsvc_torch.io.audio import load_audio, resample, save_audio, to_mono
from knnsvc_torch.io.loudness import normalize_loudness
from knnsvc_torch.io.checkpoints import load_params
from knnsvc_torch.io.jax_params import generator_from_numpy, wavlm_from_numpy
from knnsvc_torch.match.pipeline import (SHARDED_MATCHERS, ConversionFeatures,
                                         check_sharded_int8, pool_mesh_for)
from knnsvc_torch.precision import apply_precision
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index, one_hot_layer

BUCKET_FRAMES = 250   # frame bucket of the bulk loops' query padding and vocoding


def _bucket(n: int, bucket: int = BUCKET_FRAMES) -> int:
    return -(-n // bucket) * bucket


def _pool_args(ref, use_harm: bool):
    """The pool arguments of match_utterance / match_utterances_batched for
    a device pool, or for a ShardedPool (passed as sharded=, the dense
    arguments None): -> ((matching, synth, f0, harmonics), sharded)."""
    from knnsvc_torch.parallel.sharded_match import ShardedPool

    if isinstance(ref, ShardedPool):
        return (None, None, None, None), ref
    return (ref.matching, ref.synth, ref.f0, ref.harmonics if use_harm else None), None


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA request without a card raises instead of
    falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "knnsvc_torch: device='cuda' was requested but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"knnsvc_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def scan_checkpoint(ckpt_dir: str, substring: str) -> str | None:
    """Latest file in ckpt_dir matching *substring* (ref hifigan/utils.py:55-60):
    the last of the sorted glob matches, or None."""
    matches = glob.glob(os.path.join(ckpt_dir, f"*{substring}*"))
    return sorted(matches)[-1] if matches else None


class _StreamRunner:
    """The chunk-conversion loop of stream_convert_chunks (the whole
    waveform known up front) and StreamSession (samples arriving live). It
    holds all cross-chunk state on the device: the cached encoder's K/V
    ring, the last C final frames' features (`feat_buf`), the concat-cost
    carry (the previous emitted frame's picks and the sticky weight, ref
    lib_ongaku_test.py:294-336) and the vocoder tail's features; and on the
    device too, the voiced f0 seen so far, whose log-median anchors every
    chunk's register shift. It converts every chunk that is final given the
    samples received: with eof all of them; without, only those whose whole
    lookahead (plus the conv receptive field's margin) has arrived, so a
    chunk's output never depends on when its samples were pushed."""

    def __init__(self, svc: "KnnSvc", ref_wav_file, *, F: int, C: int, CR: int, topk: int,
                 prioritize_f0: bool, po: PostOpt, matcher: str, vm: int, encoder: str,
                 cache_s: float):
        from knnsvc_torch.match.pool import build_device_pool, load_utterance

        self.svc, self.F, self.C, self.CR, self.vm = svc, F, C, CR, vm
        self.topk, self.prioritize_f0, self.po, self.matcher = topk, prioritize_f0, po, matcher
        self.use_harm = uses_harmonics(svc.ckpt_type)
        self.enc_stream = None
        # samples past (g_lo + F + CR) * hop that a live chunk waits for
        self.finality_slack = 1
        if encoder == "cached":
            from knnsvc_torch.models.wavlm.streaming import (WavLMStreamEncoder,
                                                             conv_receptive_field)

            hot = one_hot_layer(svc.weighting)
            if hot is None:
                raise ValueError("encoder='cached' needs a one-hot layer weighting "
                                 "(the serving path's case)")
            cache_frames = max(1, int(round(cache_s * svc.sr)) // HOP_LENGTH)
            self.enc_stream = WavLMStreamEncoder(svc.wavlm, hot, chunk_frames=F,
                                                 lookahead_frames=CR, cache_frames=cache_frames)
            self.finality_slack = max(1, conv_receptive_field(svc.wavlm_cfg) - HOP_LENGTH)
        with record_function("knnsvc.pool_build"):
            self.ref = build_device_pool(load_utterance(ref_wav_file, svc.sr), svc.wavlm,
                                         svc.weighting, svc.weighting, svc.sr,
                                         f0_method=svc.f0_method, audio_path=str(ref_wav_file))
        self.sharded = None
        if matcher in SHARDED_MATCHERS:
            self.sharded = svc._shard_target(self.ref, matcher, pool_mesh_for(svc.device))
        # the sticky-weight carry threads through the concat-cost reselection
        # of the dense matchers; the sharded ones match each window alone, as
        # the JAX package does
        self.continuity = po.concat_weight != -1.0 and matcher in ("exact", "approx")
        self.feat_buf = None     # (<= C, D): the last C final frames' features
        self.carry = None        # (picks (L, k), weight) after the last emitted frame
        self.tail = None         # (features, harmonics, first global frame) of the last chunk
        self.voiced = None       # voiced f0 of the emitted frames
        self.chunk_idx = 0
        self.done = False

    def required_samples(self) -> int:
        """Absolute sample count the next chunk needs before it converts
        mid-stream (its whole lookahead and the encoder's margin)."""
        return (self.chunk_idx * self.F + self.F + self.CR) * HOP_LENGTH + self.finality_slack

    def history_start(self) -> int:
        """The earliest absolute sample the next chunk reads: a live session
        may drop everything before it."""
        return max(0, (self.chunk_idx * self.F - self.C) * HOP_LENGTH)

    def emit(self, buf: np.ndarray, start: int, eof: bool):
        """Convert every chunk that is final now. buf[i] is absolute sample
        start + i (earlier samples may be dropped, never past
        history_start()); eof marks the waveform complete, which lets the
        trailing partial chunks through. Yields float32 chunks."""
        L = start + len(buf)          # absolute samples seen so far
        while not self.done:
            g_lo = self.chunk_idx * self.F
            if eof:
                if g_lo * HOP_LENGTH >= L:
                    self.done = True
                    return
            elif L < self.required_samples():
                return
            with record_function("knnsvc.stream_chunk"):
                chunk = self._convert(buf, start, L, g_lo, eof)
            if chunk is None:
                return
            yield chunk

    def _window_features(self, seg, L: int, g_lo: int, window: np.ndarray, eof: bool):
        """The window's features and f0 on the device: (features (T, D),
        f0 (T,), c_lo, the window-local index of the chunk's first frame),
        or None at the end of the input."""
        from knnsvc_torch.dsp.f0 import get_f0
        from knnsvc_torch.match.pool import build_device_pool
        from knnsvc_torch.models.wavlm.model import frame_count

        svc, hop, F, C, CR = self.svc, HOP_LENGTH, self.F, self.C, self.CR
        if self.enc_stream is None:
            with record_function("knnsvc.pool_build"):
                wpool = build_device_pool(window, svc.wavlm, svc.weighting, svc.weighting,
                                          svc.sr, f0_method=svc.f0_method)
            with record_function("knnsvc.f0_join"):
                q_f0 = wpool.f0
            return wpool.matching, q_f0, g_lo - max(0, g_lo - C)
        if eof:
            # the frame budget of the whole input under the reference's pad
            # quirk (ref ddsp_prematch_dataset.py:284), as a window derives it
            total_frames = frame_count(svc.wavlm_cfg, L + hop - L % hop)
            frames_this = min(F + CR, total_frames - g_lo)
            if frames_this <= 0:
                return None
        else:
            frames_this = F + CR
        s0 = g_lo * hop
        raw = seg(s0, s0 + self.enc_stream.sample_len)
        feats_new = self.enc_stream.step(
            np.pad(raw, (0, self.enc_stream.sample_len - len(raw))))[:frames_this]
        c_lo = min(C, g_lo)
        q_match = feats_new if c_lo == 0 else torch.cat([self.feat_buf[-c_lo:], feats_new])
        # host f0 over the window's audio and framing, as the windowed mode's
        with record_function("knnsvc.stream_f0"):
            f0 = get_f0(np.pad(window, (0, hop - len(window) % hop)), svc.sr,
                        use_sidecar=False, write_sidecar=False, method="fast")
        q_f0 = torch.from_numpy(np.asarray(f0[:c_lo + frames_this], np.float32)).to(svc.device)
        n_fin = min(F, frames_this)
        self.feat_buf = (feats_new[:n_fin] if self.feat_buf is None else
                         torch.cat([self.feat_buf, feats_new[:n_fin]])[-max(C, 1):])
        return q_match, q_f0, c_lo

    def _download(self, wav: torch.Tensor) -> np.ndarray:
        from knnsvc_torch.match.serve import quantize_int16

        with record_function("knnsvc.quantize_download"):
            return quantize_int16(wav).cpu().numpy().astype(np.float32) / 32768.0

    @torch.no_grad()
    def _convert(self, buf: np.ndarray, start: int, L: int, g_lo: int, eof: bool):
        """The chunk starting at global frame g_lo, or None (and done) when
        the input has run out."""
        from knnsvc_torch.match.f0_logic import masked_log_median
        from knnsvc_torch.match.pipeline import match_utterance, match_utterance_stream

        svc, hop, F, vm, ref = self.svc, HOP_LENGTH, self.F, self.vm, self.ref

        def seg(a, b):                 # absolute slice (b may run past L)
            if a < start:
                raise AssertionError((a, start))
            return buf[a - start: max(b - start, 0)]

        w0 = max(0, g_lo - self.C) * hop
        window = seg(w0, min(L, (g_lo + F + self.CR) * hop))
        # build_device_pool drops a chunk of <= MIN_CHUNK_SECONDS * sr (one hop)
        found = None if len(window) <= hop else self._window_features(seg, L, g_lo, window, eof)
        if found is None:
            self.done = True
            return None
        q_match, q_f0, c_lo = found
        t_local = q_match.shape[0]
        if c_lo >= t_local:
            self.done = True
            return None
        c_hi = min(c_lo + F, t_local)
        # the end of the input comes from the sample position: the conv
        # frontend trims edge frames, so a short encode is no end of input
        last = eof and (g_lo + F) * hop >= L
        if not last and c_hi < c_lo + F:
            raise ValueError(
                f"streaming window encoded to {t_local} frames, fewer than the {c_lo + F} "
                f"needed for a full mid-stream chunk: increase context_s (>= "
                f"{2 * hop / svc.sr:.3f}s) so the encoder's edge trim eats context, not output")
        new_v = q_f0[c_lo:c_hi]
        new_v = new_v[new_v > 0]
        self.voiced = new_v if self.voiced is None else torch.cat([self.voiced, new_v])
        anchor = float(masked_log_median(self.voiced)) if len(self.voiced) else None
        if self.continuity:
            harmonics = ref.harmonics if self.use_harm else None
            with record_function("knnsvc.match"):
                out_s, shifted, harm_s, carry_at = match_utterance_stream(
                    q_match, q_f0, ref.matching, ref.synth, ref.f0, harmonics,
                    ckpt_type=svc.ckpt_type, post_opt=self.po, scan_from=c_lo,
                    carry=self.carry, topk=self.topk, matcher=self.matcher,
                    query_f0_log_median=anchor)
            if not last:
                self.carry = carry_at(c_hi)
            # vocoder margins: on the left the previous chunk's emitted
            # features, on the right this window's
            v_hi = min(t_local, c_hi + vm)
            tail = self.tail
            lm = 0 if tail is None else min(vm, c_lo, g_lo - tail[2])
            feats_v = out_s[: v_hi - c_lo]
            harm_v = None if harm_s is None else harm_s[: v_hi - c_lo]
            if lm > 0:
                off = g_lo - lm - tail[2]
                feats_v = torch.cat([tail[0][off:off + lm], feats_v])
                if harm_v is not None:
                    harm_v = torch.cat([tail[1][off:off + lm], harm_v])
            wav = svc._vocode_tensor(feats_v[None], shifted[None, c_lo - lm: v_hi],
                                     None if harm_v is None else harm_v[None])
            a = lm * hop
            self.tail = (out_s, harm_s, g_lo)
        else:
            pool, sharded = _pool_args(ref if self.sharded is None else self.sharded,
                                       self.use_harm)
            with record_function("knnsvc.match"):
                feats = match_utterance(
                    q_match, q_f0, *pool, svc.ckpt_type, post_opt=self.po, topk=self.topk,
                    prioritize_f0=self.prioritize_f0, matcher=self.matcher, sharded=sharded,
                    as_numpy=False, query_f0_log_median=anchor)
            v_lo, v_hi = max(0, c_lo - vm), min(t_local, c_hi + vm)
            on = lambda x: None if x is None else x[None, v_lo:v_hi].to(svc.device)
            wav = svc._vocode_tensor(on(feats.out_feats_weighted), on(feats.shifted_query_f0),
                                     on(feats.harmonics_out_feats_weighted))
            a = (c_lo - v_lo) * hop
        chunk = self._download(wav[0, a: a + (c_hi - c_lo) * hop])
        if last:
            self.done = True
        else:
            self.chunk_idx += 1
        return chunk


class StreamSession:
    """Push-based live conversion, made by KnnSvc.stream_session(): feed
    samples of any size as they arrive (a mic callback, a socket) and get
    back the converted audio of each chunk_s block the moment it is final.
    All cross-chunk state lives in the session, on the device, and consumed
    history is dropped: memory stays O(chunk + context) however long the
    stream runs.

        sess = knn.stream_session("target.wav", chunk_s=2.0)
        out = sess.push(samples)    # float32 audio, possibly empty
        ...
        out = sess.flush()          # the trailing partial chunks

    A whole utterance pushed in any pieces and flushed gives audio
    bit-identical to stream_convert_chunks on the same settings."""

    def __init__(self, runner: _StreamRunner, sr: int):
        self._runner = runner
        self.sr = sr
        self._buf = np.zeros(0, np.float32)
        self._start = 0            # absolute sample index of _buf[0]
        self._flushed = False

    @property
    def pending_s(self) -> float:
        """Seconds received but not yet emitted as converted audio."""
        emitted = self._runner.chunk_idx * self._runner.F * HOP_LENGTH
        return max(0.0, (self._start + len(self._buf) - emitted) / self.sr)

    def push(self, samples) -> np.ndarray:
        """Append samples; convert and return every chunk they made final."""
        if self._flushed:
            raise RuntimeError("stream session already flushed")
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32).reshape(-1)])
        out = list(self._runner.emit(self._buf, self._start, eof=False))
        keep = self._runner.history_start()
        if keep > self._start:
            self._buf = self._buf[keep - self._start:]
            self._start = keep
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def flush(self) -> np.ndarray:
        """End of stream: convert the remaining (partial) chunks."""
        if self._flushed:
            raise RuntimeError("stream session already flushed")
        self._flushed = True
        out = list(self._runner.emit(self._buf, self._start, eof=True))
        self._buf = np.zeros(0, np.float32)
        return np.concatenate(out) if out else np.zeros(0, np.float32)


ENCODERS = ("wavlm", "w2v-bert-2.0")    # random_init's encoder names


class KnnSvc:
    """kNN-SVC conversion engine (ref KNeighborsVC). Takes the JAX package's
    parameter pytrees (numpy) and builds the port's modules on `device`.

    The content encoder follows the type of `wavlm_cfg`: a WavLMConfig
    builds WavLM from its pytree; a W2VBertConfig builds w2v-BERT 2.0
    (models/w2vbert) from a state dict under HF's Wav2Vec2BertModel names,
    held in `self.wavlm` all the same. Either gives the features of its
    configuration's `feature_layer`. w2v-BERT 2.0 serves
    `convert_pair(fast=True)` and the legacy feature surface at that layer;
    the host-pool, bulk and streaming paths and the sharded matchers raise
    NotImplementedError for it."""

    def __init__(self, wavlm_params, wavlm_cfg: WavLMConfig | W2VBertConfig, hifigan_params,
                 hifigan_cfg: HiFiGANConfig, ckpt_type: str = "mix",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        apply_precision()
        self.wavlm_cfg = wavlm_cfg
        self.h = hifigan_cfg
        self.ckpt_type = ckpt_type
        self.family = model_family_for_ckpt_type(ckpt_type)
        if isinstance(wavlm_cfg, W2VBertConfig):
            from knnsvc_torch.models.w2vbert import w2vbert_from_state_dict

            self.wavlm = w2vbert_from_state_dict(wavlm_params, wavlm_cfg, self.device)
        else:
            self.wavlm = wavlm_from_numpy(wavlm_params, wavlm_cfg, self.device)
        self.vocoder = generator_from_numpy(hifigan_params, hifigan_cfg, self.family,
                                            self.device)
        self.sr = hifigan_cfg.sampling_rate
        self.hop_length = HOP_LENGTH
        self.weighting = generate_matrix_from_index(wavlm_cfg.feature_layer)
        # the fast path's f0 extractor: 'fast' (native budget Harvest on a
        # background thread), 'harvest' / 'dio' / 'yin', or 'device' (the
        # device extractor inside the pool build, no host work)
        self.f0_method = "fast"

    def _wavlm_only(self, path: str) -> None:
        """Raise for a path that serves the WavLM encoder alone."""
        if isinstance(self.wavlm_cfg, W2VBertConfig):
            raise NotImplementedError(f"{path} serves the WavLM encoder only, not w2v-BERT 2.0")

    # ------------------------------------------------------------- factory

    @classmethod
    def load(cls, ckpt_dir: str, ckpt_type: str = "mix", wavlm_ckpt: str | None = None,
             config_path: str | None = None, device: str | torch.device = "cuda",
             encoder_ckpt: str | None = None) -> "KnnSvc":
        """Build from a checkpoint directory (ref ddsp_hubconf.knn_vc). The
        HiFi-GAN file is the latest match of `*<ckpt_type>*` in ckpt_dir that
        is not a `do_` (discriminator) file and dispatches to the same model
        family: a reference `g_*.pt` ({'generator': state_dict}, weight norm
        folded on load) or a `.knnsvc.pkl` pytree written by the JAX
        package. The WavLM file is `wavlm_ckpt` (default
        <ckpt_dir>/WavLM-Large.pt): a torch `.pt` ({'cfg', 'model'}) or a
        `.knnsvc.pkl`. A directory with no such file but an `orbax/`
        checkpoint directory (train(checkpoint_backend='orbax') of either
        package) serves the generator of its newest TrainState.

        encoder_ckpt, in place of wavlm_ckpt, serves w2v-BERT 2.0 from a torch
        file of a Wav2Vec2BertModel state dict under HF's names, bare (the
        published widths) or as {'cfg': HF config.json keys, 'model': state
        dict}."""
        from knnsvc_torch.io.checkpoints import load_hifigan_checkpoint, load_wavlm_checkpoint

        if encoder_ckpt is not None and wavlm_ckpt is not None:
            raise ValueError("pass wavlm_ckpt or encoder_ckpt, not both")

        h = HiFiGANConfig() if config_path is None else HiFiGANConfig.from_json(config_path)
        family = model_family_for_ckpt_type(ckpt_type)
        matches = [p for p in glob.glob(os.path.join(ckpt_dir, f"*{ckpt_type}*"))
                   if not os.path.basename(p).startswith("do_")
                   and model_family_for_ckpt_type(os.path.basename(p)) == family]
        cp_g = sorted(matches)[-1] if matches else None
        if cp_g is None:
            orbax_dir = os.path.join(ckpt_dir, "orbax")
            if not os.path.isdir(orbax_dir):
                raise FileNotFoundError(f"no checkpoint matching *{ckpt_type}* in {ckpt_dir}")
            from knnsvc_torch.io.orbax_ckpt import restore_params

            hifigan_params, _ = restore_params(orbax_dir, "g_params")
        elif cp_g.endswith(".knnsvc.pkl"):
            payload = load_params(cp_g)
            # trained g_ checkpoints wrap the params as {'generator': ...}
            hifigan_params = payload.get("generator", payload)
        else:
            hifigan_params = load_hifigan_checkpoint(cp_g, h, family)

        if encoder_ckpt is not None:
            payload = torch.load(encoder_ckpt, map_location="cpu", weights_only=True)
            if "model" in payload:
                return cls(payload["model"], W2VBertConfig.from_dict(payload.get("cfg") or {}),
                           hifigan_params, h, ckpt_type, device=device)
            return cls(payload, W2VBertConfig(), hifigan_params, h, ckpt_type, device=device)
        if wavlm_ckpt is None:
            wavlm_ckpt = os.path.join(ckpt_dir, "WavLM-Large.pt")
        if wavlm_ckpt.endswith(".knnsvc.pkl"):
            payload = load_params(wavlm_ckpt)
            if isinstance(payload, dict) and "model" in payload:
                # {'cfg': dict, 'model': params}, the torch checkpoint's own shape
                wavlm_params = payload["model"]
                wavlm_cfg = WavLMConfig.from_dict(payload.get("cfg") or {})
            else:
                wavlm_params, wavlm_cfg = payload, WavLMConfig()
        else:
            wavlm_params, wavlm_cfg = load_wavlm_checkpoint(wavlm_ckpt)
        return cls(wavlm_params, wavlm_cfg, hifigan_params, h, ckpt_type, device=device)

    @classmethod
    def random_init(cls, ckpt_type: str = "mix", seed: int = 0,
                    device: str | torch.device = "cuda", encoder: str = "wavlm") -> "KnnSvc":
        """Random weights at full architecture size (WavLM-Large, or
        w2v-BERT 2.0 with encoder='w2v-bert-2.0'; HiFi-GAN v1 config), drawn
        on the CPU from a torch.Generator seeded with `seed`, so every device
        gets the same weights."""
        resolve_device(device)
        if encoder not in ENCODERS:
            raise ValueError(f"encoder must be one of {ENCODERS}, not {encoder!r}")
        from knnsvc_torch.models.hifigan.generator import init_generator_params
        from knnsvc_torch.models.w2vbert import init_w2vbert_params
        from knnsvc_torch.models.wavlm.model import init_wavlm_params

        h = HiFiGANConfig()
        gen = torch.Generator().manual_seed(seed)
        if encoder == "wavlm":
            wavlm_cfg = WavLMConfig()
            wavlm_params = init_wavlm_params(wavlm_cfg, gen)
        else:
            wavlm_cfg = W2VBertConfig()
            wavlm_params = init_w2vbert_params(wavlm_cfg, gen)
        hifigan_params = init_generator_params(h, model_family_for_ckpt_type(ckpt_type), gen)
        return cls(wavlm_params, wavlm_cfg, hifigan_params, h, ckpt_type, device=device)

    # ------------------------------------------------------------- conversion

    def _default_output_path(self, src_wav_file: str, ref_wav_file: str, suffix: str) -> str:
        """Reference naming: <src_dir>/<src>_to_<ref>_knn_<ckpt>_<suffix>.wav
        (ref ddsp_matcher.py:1013-1015)."""
        src_id = os.path.basename(src_wav_file).split(".")[0]
        ref_id = os.path.basename(ref_wav_file).split(".")[0]
        return os.path.join(str(Path(src_wav_file).parent),
                            f"{src_id}_to_{ref_id}_knn_{self.ckpt_type}_{suffix}.wav")

    def convert_waveform(self, src_wav_file: str, ref_wav_file: str, topk: int = 4,
                         post_opt: str = "no_post_opt", matcher: str = "exact",
                         upload_dtype: str = "float32", mesh=None) -> torch.Tensor:
        """The fast path up to the vocoder: both device pools, the match and
        the vocode. Returns the (T*hop,) float32 waveform on the device,
        before the int16 quantize. The sharded matchers shard the target
        pool over `mesh`'s pool axis (default: every card, or the CPU)."""
        from knnsvc_torch.match.pool import build_device_pool, load_utterance
        from knnsvc_torch.match.serve import convert_pools

        if matcher not in ("exact", "approx", *SHARDED_MATCHERS):
            raise ValueError(f"--fast supports matcher 'exact', 'approx', 'sharded' or "
                             f"'sharded_int8', not {matcher!r} (the dense int8 pool is "
                             "host-prepared; use the default path for it)")
        if matcher in SHARDED_MATCHERS:
            self._wavlm_only(f"matcher {matcher!r}")
        # record_function spans name the stages in a torch.profiler trace
        pools = []
        for path in (src_wav_file, ref_wav_file):
            with record_function("knnsvc.load_wav"):
                wav = load_utterance(path, self.sr)
            with record_function("knnsvc.pool_build"):
                pools.append(build_device_pool(wav, self.wavlm, self.weighting, self.weighting,
                                               self.sr, f0_method=self.f0_method,
                                               audio_path=str(path),
                                               upload_dtype=upload_dtype))
        if matcher in SHARDED_MATCHERS:
            return self._convert_sharded(pools[0], pools[1], PostOpt.parse(post_opt), topk,
                                         matcher, mesh)
        wav, _ = convert_pools(self.vocoder, self.ckpt_type, pools[0], pools[1],
                               PostOpt.parse(post_opt), topk=topk, matcher=matcher, sr=self.sr)
        return wav

    @torch.no_grad()
    def _convert_sharded(self, src, ref, post_opt: PostOpt, topk: int, matcher: str,
                         mesh) -> torch.Tensor:
        """The fast path's match and vocode with the target pool sharded:
        -> the (T*hop,) waveform before the int16 quantize."""
        from knnsvc_torch.match.pipeline import match_utterance

        with record_function("knnsvc.f0_join"):     # joins both background f0 threads
            src_f0, _ = src.f0, ref.f0
        with record_function("knnsvc.match"):
            sharded = self._shard_target(ref, matcher, pool_mesh_for(self.device, mesh))
            feats = match_utterance(src.matching, src_f0, None, None, None, None,
                                    self.ckpt_type, post_opt, topk=topk, matcher=matcher,
                                    sharded=sharded, as_numpy=False)
        on = lambda x: None if x is None else x[None].to(self.device)
        return self._vocode_tensor(on(feats.out_feats_weighted), on(feats.shifted_query_f0),
                                   on(feats.harmonics_out_feats_weighted))[0]

    # ------------------------------------------------------------- features

    @torch.no_grad()
    def get_features(self, path_or_wave, weights: np.ndarray | None = None,
                     vad_trigger_level: float = 0.0) -> np.ndarray:
        """(T, D) features of a waveform or path, with an optional VAD edge
        trim (ref ddsp_matcher.py:437-517): a one-hot weighting at a layer >=
        1 runs the early-exit encoder, any other the all-layer weighted sum."""
        from knnsvc_torch.io.vad import vad_trim

        if isinstance(path_or_wave, (str, Path)):
            x, sr = load_audio(path_or_wave)
            x = to_mono(x)[0]
            if sr != self.sr:
                x = resample(x, sr, self.sr)
        else:
            x = np.asarray(path_or_wave, dtype=np.float32).reshape(-1)
        if vad_trigger_level > 1e-3:
            x, _, _ = vad_trim(x, self.sr, vad_trigger_level)
        w = self.weighting if weights is None else np.asarray(weights)
        hot = one_hot_layer(w)
        wav = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)[None]
        if hot is not None and hot >= 1:
            return self.wavlm.extract_layer(wav, output_layer=hot)[0].cpu().numpy()
        stack = self.wavlm.extract_all_layers(wav)[:, 0]
        w = torch.from_numpy(np.asarray(w, np.float32).reshape(-1, 1, 1)).to(self.device)
        return (stack * w).sum(0).cpu().numpy()

    def get_matching_set(self, wavs: Sequence, weights=None,
                         vad_trigger_level: float = 7.0) -> np.ndarray:
        """Concatenated features of a list of paths or waveforms
        (ref ddsp_matcher.py:331-342)."""
        return np.concatenate([self.get_features(w, weights, vad_trigger_level) for w in wavs])

    def get_f0(self, wav_file: str) -> np.ndarray:
        """Host f0 of a file at self.sr (its `<stem>_f0.npy` sidecar first)."""
        from knnsvc_torch.dsp.f0 import get_f0

        x, sr = load_audio(wav_file)
        if sr != self.sr:
            raise ValueError(f"{wav_file} is at {sr} Hz; get_f0 takes {self.sr}-Hz audio")
        return get_f0(to_mono(x)[0], sr, audio_path=wav_file)

    # ------------------------------------------------------------- vocoding

    def _vocode_tensor(self, feats: torch.Tensor, f0: torch.Tensor | None,
                       harm: torch.Tensor | None) -> torch.Tensor:
        """(B, T, D)[, (B, T)][, (B, T, 49)] on the device -> (B, T*hop)."""
        from knnsvc_torch.config import ModelFamily

        with record_function("knnsvc.vocode"):
            if self.family == ModelFamily.ORIGINAL:
                return self.vocoder(feats)
            return self.vocoder(feats, None if f0 is None else f0[..., None], harm)

    @torch.no_grad()
    def vocode(self, feats, f0=None, harmonics=None) -> np.ndarray:
        """(T, D)[, (T,)][, (T, 49)] -> waveform (T*hop,) float32
        (ref ddsp_matcher.py:374-406)."""
        from knnsvc_torch.config import ModelFamily

        if self.family == ModelFamily.MIX and harmonics is None:
            raise ValueError("mix-family checkpoints need harmonic amplitudes; use "
                             "convert_pair/convert_features (which compute them) or pass "
                             "harmonics=(T, 49); the legacy match() surface fits "
                             "wavlm_only-family checkpoints")
        if self.family != ModelFamily.ORIGINAL and f0 is None:
            raise ValueError(f"{self.family} checkpoints need f0; only "
                             "wavlm_only_original vocodes features alone")
        as_dev = lambda a: (None if a is None else torch.as_tensor(a).to(
            device=self.device, dtype=torch.float32)[None])
        wav = self._vocode_tensor(as_dev(feats), as_dev(f0), as_dev(harmonics))
        return wav[0].cpu().numpy()

    @torch.no_grad()
    def mel_vocode(self, wav: np.ndarray, f0: np.ndarray) -> np.ndarray:
        """Vocode the log-mel of `wav` as features (debug path, ref
        ddsp_matcher.py:346-368); only meaningful for checkpoints trained on
        mel input (hubert_dim == num_mels). Mix-family checkpoints need
        harmonics and raise."""
        from knnsvc_torch.dsp.stft import log_mel_spectrogram

        h = self.h
        x = torch.from_numpy(np.asarray(wav, dtype=np.float32).reshape(1, -1)).to(self.device)
        mel = log_mel_spectrogram(x, n_fft=h.n_fft, num_mels=h.num_mels,
                                  sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                                  win_size=h.win_size, fmin=h.fmin, fmax=h.fmax).transpose(1, 2)
        f0 = np.asarray(f0, dtype=np.float32).reshape(-1)[: mel.shape[1]]
        f0_t = torch.from_numpy(f0).to(self.device).reshape(1, -1, 1)
        return self.vocoder(mel, f0_t, None)[0].cpu().numpy()

    @torch.no_grad()
    def match(self, query_seq: np.ndarray, matching_set: np.ndarray,
              query_f0: np.ndarray | None = None, synth_set: np.ndarray | None = None,
              topk: int = 4, tgt_loudness_db: float | None = None,
              target_duration: float | None = None,
              without_vocode: bool = False) -> np.ndarray:
        """Classic knn-vc matcher (ref ddsp_matcher.py:520-644, dead code
        past a debug sys.exit there; this is its documented semantics): the
        mean of the top-k `synth_set` rows selected against `matching_set`,
        then vocode. target_duration linearly resamples the query track."""
        from knnsvc_torch.match.knn import knn_topk

        query = np.asarray(query_seq, dtype=np.float32)
        matching = torch.from_numpy(np.asarray(matching_set, dtype=np.float32)).to(self.device)
        synth = matching if synth_set is None else torch.from_numpy(
            np.asarray(synth_set, dtype=np.float32)).to(self.device)
        if target_duration is not None:
            target_frames = int(target_duration * self.sr / self.hop_length)
            src_pos = np.linspace(0, len(query) - 1, target_frames)
            lo = np.floor(src_pos).astype(int)
            hi = np.minimum(lo + 1, len(query) - 1)
            frac = (src_pos - lo)[:, None]
            query = query[lo] * (1 - frac) + query[hi] * frac
        idx, _ = knn_topk(torch.from_numpy(np.asarray(query, np.float32)).to(self.device),
                          matching, k=topk)
        out_feats = synth[idx].mean(dim=1).cpu().numpy()
        if without_vocode:
            return out_feats
        f0 = None
        if query_f0 is not None:
            f0 = np.asarray(query_f0, dtype=np.float32).reshape(-1)[: len(out_feats)]
        pred = self.vocode(out_feats, f0)
        if tgt_loudness_db is not None:
            pred = normalize_loudness(pred, self.sr, tgt_loudness_db)
        return pred

    @torch.no_grad()
    def self_match(self, query_seq: np.ndarray, query_f0: np.ndarray | None = None,
                   topk: int = 4, exclude_self: bool = True,
                   without_vocode: bool = False) -> np.ndarray:
        """A sequence matched against itself (ref ddsp_matcher.py:645-758);
        exclude_self keeps frame t from picking itself. Ties keep ascending
        frame order."""
        from knnsvc_torch.match.distance import cosine_distance

        q = torch.from_numpy(np.asarray(query_seq, dtype=np.float32)).to(self.device)
        dists = cosine_distance(q, q)
        if exclude_self:
            eye = torch.eye(q.shape[0], dtype=torch.bool, device=self.device)
            dists = dists.masked_fill(eye, torch.inf)
        idx = torch.sort(dists, dim=1, stable=True).indices[:, :topk]
        out_feats = q[idx].mean(dim=1).cpu().numpy()
        if without_vocode:
            return out_feats
        f0 = None if query_f0 is None else np.asarray(query_f0, np.float32)[: len(out_feats)]
        return self.vocode(out_feats, f0)

    @torch.no_grad()
    def vocode_batch(self, features: list[ConversionFeatures],
                     bucket_frames: int = BUCKET_FRAMES) -> list[np.ndarray]:
        """Vocode utterances together, zero-padded to frame buckets: one
        vocoder call per bucket, outputs cut to their true lengths. Bucket
        padding changes only the samples within the generator's receptive
        field of the pad boundary (the JAX package bounds it at 1e-4 per
        sample, tests/test_vocode_tail.py); the reference vocodes one by one
        (ref ddsp_matcher.py:1106)."""
        with record_function("knnsvc.vocode_batch"):
            groups: dict[int, list[int]] = {}
            for i in np.argsort([len(f.out_feats_weighted) for f in features]):
                groups.setdefault(_bucket(len(features[i].out_feats_weighted), bucket_frames),
                                  []).append(int(i))
            results: list[np.ndarray | None] = [None] * len(features)
            for bucket, idxs in groups.items():
                def stack(field):
                    arrs = [getattr(features[i], field) for i in idxs]
                    if arrs[0] is None:
                        return None
                    return torch.from_numpy(np.stack([
                        np.pad(a, [(0, bucket - len(a))] + [(0, 0)] * (a.ndim - 1))
                        for a in arrs]).astype(np.float32)).to(self.device)
                wavs = self._vocode_tensor(stack("out_feats_weighted"),
                                           stack("shifted_query_f0"),
                                           stack("harmonics_out_feats_weighted")).cpu().numpy()
                for row, i in enumerate(idxs):
                    results[i] = wavs[row, : len(features[i].out_feats_weighted) * self.hop_length]
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------- conversion

    def convert_features(self, src_path, ref_path, topk: int = 4, prioritize_f0: bool = True,
                         post_opt: str = "no_post_opt", duration_limit: float | None = None,
                         required_subset=None, query_pool=None, ref_pool=None,
                         matcher: str = "exact", mesh=None) -> dict[str, ConversionFeatures]:
        """Host pools of source and target (built unless passed in) matched
        on the device: {source utterance path: ConversionFeatures}. The
        sharded matchers shard the target pool over `mesh`'s pool axis."""
        from knnsvc_torch.match.pipeline import match_at_inference_time

        self._wavlm_only("the host-pool path (convert_pair(fast=False), convert_features)")
        with record_function("knnsvc.bulk_match"):
            return match_at_inference_time(
                src_path, ref_path, self.wavlm, self.weighting, self.weighting, topk=topk,
                prioritize_f0=prioritize_f0, ckpt_type=self.ckpt_type,
                required_subset=required_subset, post_opt=post_opt,
                duration_limit=duration_limit, query_pool=query_pool, ref_pool=ref_pool,
                matcher=matcher, mesh=mesh)

    def convert_pair(self, src_wav_file: str, ref_wav_file: str, topk: int = 4,
                     prioritize_f0: bool = True, post_opt: str = "no_post_opt",
                     tgt_loudness_db: float | None = None,
                     output_path: str | None = None, matcher: str = "exact",
                     fast: bool = False, upload_dtype: str = "float32", mesh=None) -> str:
        """Single file -> single file (ref special_match :937-1023). Writes
        `<src_dir>/<src>_to_<ref>_knn_<ckpt_type>_<post_opt>.wav` unless
        output_path is given (a `.flac` path writes FLAC); returns the output
        path. post_opt takes 'no_post_opt', 'post_opt_<w>', 'post_opt_extra'
        or 'no_post_opt_<w>' (concat without the optimizer). tgt_loudness_db,
        when set, normalizes the output to that integrated loudness (BS.1770;
        the reference's is commented out, ref :997-1003).

        fast=False (the reference's path) builds host pools of both files
        (features on the card, Harvest f0 or its `<stem>_f0.npy` sidecar,
        the whole-utterance spectrogram's harmonics), matches on the card
        with matcher 'exact', 'approx' or 'int8', and writes the float
        waveform. fast=True is the device-resident serving path: pools,
        match and vocode stay on the device, f0 comes from `self.f0_method`
        (a host extractor or its sidecar, or 'device'), and the output is
        quantized to int16 on the device and downloaded once;
        upload_dtype='int16' quantizes its two waveform uploads to 16 bits
        (lossless for 16-bit-sourced audio).

        matcher 'sharded' or 'sharded_int8' (both paths) shards the target
        pool over the pool axis of `mesh` (a parallel.Mesh; default: every
        card, or the CPU); 'sharded_int8' stores its matching rows int8 and
        serves no_post_opt only."""
        if not prioritize_f0:
            raise ValueError("prioritize_f0 is mandatory on the reference live path (ref :1375)")
        # the request's root span: every other span of the call nests in it
        with record_function("knnsvc.convert_pair"):
            if fast:
                from knnsvc_torch.match.serve import quantize_int16

                wav = self.convert_waveform(src_wav_file, ref_wav_file, topk=topk,
                                            post_opt=post_opt, matcher=matcher,
                                            upload_dtype=upload_dtype, mesh=mesh)
                with record_function("knnsvc.quantize_download"):
                    pred = quantize_int16(wav).cpu().numpy().astype(np.float32) / 32768.0
            else:
                results = self.convert_features(Path(src_wav_file), Path(ref_wav_file),
                                                topk=topk, post_opt=post_opt, matcher=matcher,
                                                mesh=mesh)
                # pools key utterances by str(Path(...)): './x.wav' still resolves
                feats = results[str(Path(src_wav_file))]
                pred = self.vocode(feats.out_feats_weighted, feats.shifted_query_f0,
                                   feats.harmonics_out_feats_weighted)
            if tgt_loudness_db is not None:
                pred = normalize_loudness(pred, self.sr, tgt_loudness_db)
            if output_path is None:
                output_path = self._default_output_path(src_wav_file, ref_wav_file, post_opt)
            with record_function("knnsvc.write_wav"):
                save_audio(output_path, pred, self.sr)
        return output_path

    # ---------------------------------------------------------- streaming

    def _stream_runner(self, ref_wav_file, chunk_s: float, context_s: float,
                       right_context_s: float | None, min_context: int, topk: int,
                       prioritize_f0: bool, post_opt: str, matcher: str,
                       vocode_margin_frames: int, encoder: str, cache_s: float,
                       n_samples: int | None = None) -> _StreamRunner:
        """Checks and frame counts of the streaming entry points: chunk F,
        left context C and right context CR in frames. The contexts are
        clamped to min_context, and to one frame when the input (n_samples,
        when known) spans several chunks: the conv frontend trims about a
        frame at each window edge, so a mid-stream window needs a hop of
        real context on each side."""
        self._wavlm_only("streaming")
        if matcher not in ("exact", "approx", *SHARDED_MATCHERS):
            raise ValueError(f"streaming supports matcher 'exact', 'approx', 'sharded' or "
                             f"'sharded_int8', not {matcher!r}")
        po = PostOpt.parse(post_opt)
        if matcher == "sharded_int8":
            check_sharded_int8(po)
        if encoder not in ("windowed", "cached"):
            raise ValueError(f"encoder must be 'windowed' or 'cached', not {encoder!r}")
        hop = HOP_LENGTH
        F = max(1, int(round(chunk_s * self.sr)) // hop)
        C = max(min_context, int(round(context_s * self.sr)) // hop)
        CR = C if right_context_s is None else max(
            min_context, int(round(right_context_s * self.sr)) // hop)
        if n_samples is not None and n_samples > F * hop:
            C, CR = max(C, 1), max(CR, 1)
        return _StreamRunner(self, ref_wav_file, F=F, C=C, CR=CR, topk=topk,
                             prioritize_f0=prioritize_f0, po=po,
                             matcher=matcher, vm=max(0, int(vocode_margin_frames)),
                             encoder=encoder, cache_s=cache_s)

    def stream_convert_chunks(self, src, ref_wav_file: str, chunk_s: float = 2.0,
                              context_s: float = 1.0, topk: int = 4, prioritize_f0: bool = True,
                              post_opt: str = "no_post_opt", matcher: str = "approx",
                              vocode_margin_frames: int = 16,
                              right_context_s: float | None = None,
                              encoder: str = "windowed", cache_s: float = 4.0):
        """Streaming conversion (no reference analogue; the reference
        converts whole utterances, ref ddsp_matcher.py:937-1023): yields the
        converted waveform in chunks of chunk_s seconds, each computed from
        a window with context_s of context before it and right_context_s
        (default context_s) after it. The algorithmic latency is chunk_s +
        right_context_s; live input wants e.g. context_s=1.0,
        right_context_s=0.1. Mid-stream contexts are at least one hop.

        Per chunk, encoder='windowed' encodes the window [chunk - context,
        chunk + lookahead] (6 attention-kernel launches on a card; with
        f0_method='device' one Viterbi launch); encoder='cached' encodes
        only the chunk's new frames and its lookahead over a K/V cache of
        the last cache_s seconds of final frames (models/wavlm/streaming.py;
        host f0 of the window, method 'fast'; needs a one-hot layer
        weighting). The window's frames are matched against the target pool
        (with post_opt, the concat-cost reselection of the chunk's frames
        continues from the previous chunk's last emitted frame: one kernel
        launch on a card), the chunk is vocoded with vocode_margin_frames
        of margin on each side and trimmed, quantized to int16 on the
        device and downloaded once. The register shift is anchored at the
        log-median of all voiced f0 emitted so far, so chunks do not
        re-pitch independently. matcher 'sharded' / 'sharded_int8' shards
        the target pool over the default pool mesh and matches each window
        alone (no cross-chunk concat carry, as in the JAX package).

        src: a path or a 1-D float waveform at self.sr. Yields float32
        arrays of chunk_s * sr samples (the last may be shorter)."""
        from knnsvc_torch.match.pool import load_utterance

        wav = (load_utterance(src, self.sr) if isinstance(src, (str, Path))
               else np.asarray(src, dtype=np.float32))
        # C = 0 stays honoured for an input of one chunk: no boundary to protect
        runner = self._stream_runner(
            ref_wav_file, chunk_s, context_s, right_context_s, 0, topk, prioritize_f0,
            post_opt, matcher, vocode_margin_frames, encoder, cache_s, n_samples=len(wav))
        yield from runner.emit(wav, 0, eof=True)

    def stream_convert(self, src_wav_file: str, ref_wav_file: str,
                       output_path: str | None = None, tgt_loudness_db: float | None = None,
                       **stream_kwargs) -> str:
        """The whole file through stream_convert_chunks, the chunks written
        as one file (the CLI's streaming surface). Returns the output path:
        `<src_dir>/<src>_to_<ref>_knn_<ckpt_type>_stream.wav` by default."""
        chunks = list(self.stream_convert_chunks(src_wav_file, ref_wav_file, **stream_kwargs))
        pred = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        if tgt_loudness_db is not None:
            pred = normalize_loudness(pred, self.sr, tgt_loudness_db)
        if output_path is None:
            output_path = self._default_output_path(src_wav_file, ref_wav_file, "stream")
        with record_function("knnsvc.write_wav"):
            save_audio(output_path, pred, self.sr)
        return output_path

    def stream_session(self, ref_wav_file: str, chunk_s: float = 2.0, context_s: float = 1.0,
                       topk: int = 4, prioritize_f0: bool = True,
                       post_opt: str = "no_post_opt", matcher: str = "approx",
                       vocode_margin_frames: int = 16, right_context_s: float | None = None,
                       encoder: str = "windowed", cache_s: float = 4.0) -> StreamSession:
        """A push-based live session against ref_wav_file (the target pool
        is built now): StreamSession.push(samples) converts every chunk
        whose lookahead has arrived, .flush() the trailing partial ones,
        with stream_convert_chunks' per-chunk semantics: an utterance pushed
        in any pieces and flushed gives the file stream's audio bit for bit.
        Both contexts are at least one frame (a session cannot know that
        its input is a single chunk). encoder='cached' suits live input: a
        session never hears old audio again. Memory is O(context + chunk)."""
        runner = self._stream_runner(
            ref_wav_file, chunk_s, context_s, right_context_s, 1, topk, prioritize_f0,
            post_opt, matcher, vocode_margin_frames, encoder, cache_s)
        return StreamSession(runner, self.sr)

    # ---------------------------------------------------------- fast bulk

    @torch.no_grad()
    def _device_pool_for_files(self, files, duration_limit: float | None = None):
        """One device pool over a speaker's utterances, concatenated
        (features, spectrogram and f0 on the device; harmonics gathered on
        first use). Utterances under 0.05 s are skipped; duration_limit cuts
        the pool at limit * 50 frames (the host builder cuts after the
        utterance that crosses it, ref :408-411)."""
        from knnsvc_torch.match.pool import DevicePool, build_device_pool, load_utterance

        parts = []
        total = 0
        limit_frames = None if duration_limit is None else int(duration_limit * 50)
        for f in files:
            wav = load_utterance(f, self.sr)
            if len(wav) < 0.05 * self.sr:
                continue
            p = build_device_pool(wav, self.wavlm, self.weighting, self.weighting, self.sr,
                                  f0_method=self.f0_method, audio_path=str(f))
            parts.append(p)
            total += p.matching.shape[0]
            if limit_frames is not None and total >= limit_frames:
                break
        if not parts:
            raise ValueError(f"no usable audio in {list(files)[:3]}...")
        end = total if limit_frames is None else min(total, limit_frames)
        cat = lambda xs: torch.cat(xs)[:end]
        matching = cat([p.matching for p in parts])
        synth = matching if all(p.synth is p.matching for p in parts) else cat(
            [p.synth for p in parts])
        return DevicePool(matching, synth, cat([p.spec for p in parts]),
                          f0=cat([p.f0 for p in parts]), sr=self.sr)

    def _vocode_device_bucketed(self, feats: ConversionFeatures,
                                bucket_frames: int = BUCKET_FRAMES) -> np.ndarray:
        """Vocode device-resident features zero-padded to a frame bucket,
        quantized to int16 on the device and downloaded."""
        from knnsvc_torch.match.serve import quantize_int16

        T = feats.out_feats_weighted.shape[0]
        pad = _bucket(T, bucket_frames) - T
        harm = feats.harmonics_out_feats_weighted
        wav = self._vocode_tensor(
            torch.nn.functional.pad(feats.out_feats_weighted, (0, 0, 0, pad))[None],
            torch.nn.functional.pad(feats.shifted_query_f0, (0, pad))[None],
            None if harm is None else torch.nn.functional.pad(harm, (0, 0, 0, pad))[None])
        q = quantize_int16(wav[0, : T * self.h.hop_size])
        return q.cpu().numpy().astype(np.float32) / 32768.0

    class _HostQueryCache:
        """Host-RAM LRU of (matching, f0) query tracks keyed by source file:
        a conversion's query side reads only those two, so each source
        utterance is encoded once per cache lifetime and re-uploaded per use
        (~3 MB per 15 s); `cap` bounds host RAM (2048 entries ~ 6 GB). LRU,
        not FIFO, so the bulk loops' per-target scans keep the entry they
        need next."""

        def __init__(self, svc, cap: int = 2048):
            self._svc = svc
            self._cap = cap
            self._d: collections.OrderedDict = collections.OrderedDict()

        def get(self, src_file):
            key = str(src_file)
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            if len(self._d) >= self._cap:
                self._d.popitem(last=False)
            p = self._svc._device_pool_for_files([src_file])
            self._d[key] = (p.matching.cpu().numpy(), p.f0.cpu().numpy())
            return self._d[key]

    @staticmethod
    def _bucket_pad_query(m: np.ndarray, f0: np.ndarray, bucket: int = BUCKET_FRAMES):
        """Pad a (T, D) query and its (T,) f0 to the next frame-bucket
        multiple: features by edge replication, f0 by zeros (unvoiced, so
        the voiced-median register shift is unchanged). -> (m, f0, T)."""
        T = m.shape[0]
        Tb = _bucket(T, bucket)
        if Tb != T:
            m = np.concatenate([m, np.repeat(m[-1:], Tb - T, axis=0)], 0)
            f0 = np.concatenate([f0, np.zeros(Tb - T, f0.dtype)], 0)
        return m, f0, T

    @staticmethod
    def _out_path(converted_audio_dir, spk, src_file, tgt_spk) -> str:
        """<dir>/<src_spk>/<utt>/<tgt_spk>.wav (ref ddsp_matcher.py:1127-1133)."""
        return os.path.join(converted_audio_dir, os.path.basename(spk),
                            os.path.basename(str(src_file)).split(".")[0],
                            os.path.basename(str(tgt_spk)) + ".wav")

    def _write(self, out: str, pred: np.ndarray, tgt_loudness_db, written: list) -> None:
        if tgt_loudness_db is not None:
            pred = normalize_loudness(pred, self.sr, tgt_loudness_db)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        save_audio(out, pred, self.sr)
        written.append(out)

    def _shard_target(self, ref, matcher: str, mesh):
        """A target device pool sharded over `mesh`'s pool axis (int8
        matching rows for 'sharded_int8')."""
        from knnsvc_torch.parallel.sharded_match import shard_speaker_pool

        return shard_speaker_pool(ref.matching, ref.synth, ref.f0,
                                  ref.harmonics if uses_harmonics(self.ckpt_type) else None, mesh,
                                  quantize_matching=matcher == "sharded_int8")

    def _bulk_convert_fast(self, src_spks, tgt_spks, same_root, converted_audio_dir, topk,
                           prioritize_f0, post_opt, required, duration_limit, tgt_loudness_db,
                           resume, matcher, mesh=None) -> list[str]:
        """Device-resident bulk loop, target-outer: one target device pool
        alive at a time, source query tracks in a host LRU, each query
        bucket-padded, matched on the card and vocoded bucket-padded with the
        int16 download. As the host loop but: the fast path's f0
        (`self.f0_method`), no VAD, bucket-padded vocoding (<= 1e-4 per
        sample plus one int16 step). The sharded matchers shard each target
        pool over the pool axis of `mesh` (default: the default pool
        mesh)."""
        from knnsvc_torch.match.pipeline import match_utterance, subset_key
        from knnsvc_torch.match.pool import list_speaker_utterances

        if matcher not in ("exact", "approx", *SHARDED_MATCHERS):
            raise ValueError(f"bulk_convert(fast=True) takes matcher 'exact', 'approx', "
                             f"'sharded' or 'sharded_int8', not {matcher!r}")
        popt = PostOpt.parse(post_opt)
        sharded = matcher in SHARDED_MATCHERS
        if sharded:
            mesh = pool_mesh_for(self.device, mesh)
        use_harm = uses_harmonics(self.ckpt_type)
        queries = self._HostQueryCache(self)
        written: list[str] = []
        for j, tgt_spk in enumerate(tgt_spks):
            ref = None     # built on first use: resume and subset runs may skip a target
            for i, spk in enumerate(src_spks):
                if same_root and i == j:
                    continue
                for src_file in list_speaker_utterances(spk):
                    out = self._out_path(converted_audio_dir, spk, src_file, tgt_spk)
                    if resume and os.path.exists(out):
                        continue
                    if required is not None and subset_key(str(src_file),
                                                           str(tgt_spk)) not in required:
                        continue
                    if ref is None:
                        with record_function("knnsvc.speaker_pool"):
                            ref = self._device_pool_for_files(
                                list_speaker_utterances(tgt_spk), duration_limit)
                            if sharded:
                                ref = self._shard_target(ref, matcher, mesh)
                    with record_function("knnsvc.speaker_pool"):
                        m, qf0, T = self._bucket_pad_query(*queries.get(src_file))
                    pool, sharded_pool = _pool_args(ref, use_harm)
                    with record_function("knnsvc.bulk_match"):
                        feats = match_utterance(
                            m, qf0, *pool, ckpt_type=self.ckpt_type, post_opt=popt, topk=topk,
                            prioritize_f0=prioritize_f0, matcher=matcher, sharded=sharded_pool,
                            as_numpy=False)
                    cut = lambda x: None if x is None else x[:T].to(self.device)
                    feats = ConversionFeatures(cut(feats.out_feats_weighted),
                                               cut(feats.shifted_query_f0),
                                               cut(feats.harmonics_out_feats_weighted))
                    with torch.no_grad():
                        pred = self._vocode_device_bucketed(feats)
                    self._write(out, pred, tgt_loudness_db, written)
        return written

    def _bulk_convert_fast_batched(self, src_spks, tgt_spks, same_root, converted_audio_dir,
                                   topk, prioritize_f0, post_opt, required, duration_limit,
                                   tgt_loudness_db, resume, matcher, data_batch,
                                   mesh=None) -> list[str]:
        """Bulk serving `data_batch` conversions at a time: jobs grouped by
        (target speaker, frame bucket), each group through one batched match
        (match_utterances_batched) and one batched vocoder call with one
        int16 download. A short group is filled by repeating its last job,
        whose rows are computed and dropped. Per utterance as
        `_bulk_convert_fast` (same padding, same buckets). With a mesh (its
        data axis dividing data_batch, bulk_convert checks) the batch is
        split over its data axis: the dense matchers with the pool
        replicated on each row, the sharded ones with each target pool
        sharded over the pool axis (the default pool mesh when none is
        given)."""
        from knnsvc_torch.match.pipeline import match_utterances_batched, subset_key
        from knnsvc_torch.match.pool import list_speaker_utterances
        from knnsvc_torch.match.serve import quantize_int16

        if matcher not in ("exact", "approx", *SHARDED_MATCHERS):
            raise ValueError(f"batched bulk serving takes matcher 'exact', 'approx', 'sharded' "
                             f"or 'sharded_int8', not {matcher!r}")
        if not prioritize_f0:
            raise ValueError("prioritize_f0 is mandatory on the reference live path (ref :1375)")
        popt = PostOpt.parse(post_opt)
        sharded = matcher in SHARDED_MATCHERS
        if sharded:
            mesh = pool_mesh_for(self.device, mesh)
        by_tgt: dict = {}
        for i, spk in enumerate(src_spks):
            for src_file in list_speaker_utterances(spk):
                for j, tgt_spk in enumerate(tgt_spks):
                    if same_root and i == j:
                        continue
                    out = self._out_path(converted_audio_dir, spk, src_file, tgt_spk)
                    if resume and os.path.exists(out):
                        continue
                    if required is not None and subset_key(str(src_file),
                                                           str(tgt_spk)) not in required:
                        continue
                    by_tgt.setdefault(tgt_spk, []).append((src_file, out))
        queries = self._HostQueryCache(self)
        use_harm = uses_harmonics(self.ckpt_type)
        written: list[str] = []
        for tgt_spk, jobs in by_tgt.items():   # one target pool alive at a time
            with record_function("knnsvc.speaker_pool"):
                ref = self._device_pool_for_files(list_speaker_utterances(tgt_spk),
                                                  duration_limit)
                if sharded:
                    ref = self._shard_target(ref, matcher, mesh)
                by_bucket: dict[int, list] = {}
                for job in jobs:
                    by_bucket.setdefault(_bucket(queries.get(job[0])[0].shape[0]),
                                         []).append(job)
            for bucket, bucket_jobs in by_bucket.items():
                for start in range(0, len(bucket_jobs), data_batch):
                    chunk = bucket_jobs[start:start + data_batch]
                    padded = chunk + [chunk[-1]] * (data_batch - len(chunk))
                    with record_function("knnsvc.speaker_pool"):
                        tracks = [self._bucket_pad_query(*queries.get(job[0])) for job in padded]
                    qs, qf0s = np.stack([t[0] for t in tracks]), np.stack([t[1] for t in tracks])
                    pool, sharded_pool = _pool_args(ref, use_harm)
                    with record_function("knnsvc.bulk_match"):
                        out_b, f0_b, harm_b = match_utterances_batched(
                            qs, qf0s, *pool, ckpt_type=self.ckpt_type, post_opt=popt, topk=topk,
                            matcher=matcher, mesh=mesh, sharded=sharded_pool)
                    on = lambda x: None if x is None else x.to(self.device)
                    with torch.no_grad():
                        q16 = quantize_int16(self._vocode_tensor(
                            on(out_b), on(f0_b), on(harm_b))).cpu().numpy()
                    for row, ((_, out), track) in enumerate(zip(chunk, tracks)):
                        pred = q16[row, : track[2] * self.h.hop_size].astype(np.float32) / 32768.0
                        self._write(out, pred, tgt_loudness_db, written)
        return written

    def bulk_convert(self, src_dataset_path: str, tgt_dataset_path: str,
                     converted_audio_dir: str, topk: int = 4, prioritize_f0: bool = True,
                     post_opt: str = "no_post_opt", required_subset_file: str | None = None,
                     duration_limit: float | None = None,
                     tgt_loudness_db: float | None = None, resume: bool = False,
                     batch_vocode: bool = False, pool_cache_dir: str | None = None,
                     matcher: str = "exact", max_cached_pools: int = 8, fast: bool = False,
                     data_batch: int | None = None, mesh=None) -> list[str]:
        """Dataset -> dataset (ref bulk_match :1027-1156): every (source
        speaker, target speaker) pair but the same-index self pairs when both
        roots are one; outputs `<dir>/<src_spk>/<utt>/<tgt_spk>.wav`; returns
        the paths written. Speaker folders are the roots' subfolders, those
        named `f0_cache` excepted. resume=True skips outputs that exist;
        required_subset_file (a CSV) keeps the `row[2]` keys of the rows
        whose last field is "0" (ref :1178-1181).

        fast=False, the host loop (source-outer): host pools, built once per
        source speaker and kept for the target speakers in a FIFO of at most
        `max_cached_pools` (on disk under pool_cache_dir when given),
        matched on the card; batch_vocode vocodes a pair's utterances in
        frame buckets. fast=True, the device-resident loop (target-outer):
        per-utterance device pools, the fast path's f0, bucketed queries and
        vocoding, int16 downloads; data_batch > 1 converts that many
        utterances per batched match and vocoder call. The fast loops ignore
        batch_vocode and pool_cache_dir.

        matcher 'sharded' / 'sharded_int8' shards each target pool over the
        pool axis of `mesh` (a parallel.Mesh; default: every card, or the
        CPU). A mesh with a data axis above 1 makes the fast loop batched
        (data_batch defaults to that axis and must be a multiple of it):
        the batch is split over the data axis, composed with the pool axis
        for the sharded matchers."""
        self._wavlm_only("bulk_convert")
        if not (os.path.isdir(src_dataset_path) and os.path.isdir(tgt_dataset_path)):
            raise ValueError("bulk_convert takes two dataset roots of speaker folders")
        os.makedirs(converted_audio_dir, exist_ok=True)

        def spk_folders(root):
            return sorted(p for p in Path(root).iterdir()
                          if p.is_dir() and "f0_cache" not in os.path.basename(p))

        src_spks, tgt_spks = spk_folders(src_dataset_path), spk_folders(tgt_dataset_path)
        for root, spks in ((src_dataset_path, src_spks), (tgt_dataset_path, tgt_spks)):
            if not spks:
                raise ValueError(f"{root} must be a dataset root of speaker folders")
        required = None
        if required_subset_file:
            with open(required_subset_file) as fp:
                rows = csv.reader(fp, delimiter=",", quotechar='"')
                required = {row[2] for i, row in enumerate(rows) if i != 0 and row[-1] == "0"}
        same_root = src_dataset_path == tgt_dataset_path

        if fast:
            args = (src_spks, tgt_spks, same_root, converted_audio_dir, topk, prioritize_f0,
                    post_opt, required, duration_limit, tgt_loudness_db, resume, matcher)
            n_data = 1 if mesh is None else mesh.shape["data"]
            if data_batch is None and n_data > 1:
                data_batch = n_data
            if data_batch is not None and data_batch > 1:
                # checked before any output is written
                if data_batch % n_data != 0:
                    raise ValueError(f"data_batch={data_batch} must be a multiple of the mesh "
                                     f"'data' axis ({n_data}) so each batch splits evenly")
                batched_mesh = mesh if matcher in SHARDED_MATCHERS or n_data > 1 else None
                return self._bulk_convert_fast_batched(*args, data_batch, batched_mesh)
            return self._bulk_convert_fast(*args, mesh=mesh)

        from knnsvc_torch.match.pipeline import subset_key
        from knnsvc_torch.match.pool import build_speaker_pool_cached

        written: list[str] = []
        # each target pool serves every source speaker: built once, kept in
        # a bounded FIFO (hours-scale host pools are ~10 KB per frame)
        tgt_pools: dict = {}

        def tgt_pool_for(tgt_spk):
            if tgt_spk not in tgt_pools:
                if len(tgt_pools) >= max_cached_pools:
                    tgt_pools.pop(next(iter(tgt_pools)))
                with record_function("knnsvc.speaker_pool"):
                    tgt_pools[tgt_spk] = build_speaker_pool_cached(
                        tgt_spk, self.wavlm, self.weighting, self.weighting,
                        cache_dir=pool_cache_dir, duration_limit=duration_limit)
            return tgt_pools[tgt_spk]

        for i, spk in enumerate(src_spks):
            with record_function("knnsvc.speaker_pool"):
                src_pool = build_speaker_pool_cached(spk, self.wavlm, self.weighting,
                                                     self.weighting, cache_dir=pool_cache_dir)
            for j, tgt_spk in enumerate(tgt_spks):
                if same_root and i == j:
                    continue
                pair_subset = required
                if resume:
                    todo = [u for u in src_pool.utterances
                            if not os.path.exists(self._out_path(converted_audio_dir, spk, u,
                                                                 tgt_spk))]
                    if not todo:
                        continue
                    # convert only the missing outputs, through the subset filter
                    todo_keys = {subset_key(u, str(tgt_spk)) for u in todo}
                    pair_subset = todo_keys if required is None else todo_keys & required
                results = self.convert_features(
                    spk, tgt_spk, topk=topk, prioritize_f0=prioritize_f0, post_opt=post_opt,
                    duration_limit=duration_limit, required_subset=pair_subset,
                    query_pool=src_pool, ref_pool=tgt_pool_for(tgt_spk), matcher=matcher,
                    mesh=mesh)
                batch_preds: dict[str, np.ndarray] = {}
                if batch_vocode and results:
                    keys = list(results)
                    batch_preds = dict(zip(keys, self.vocode_batch([results[k] for k in keys])))
                for src_file, feats in results.items():
                    out = self._out_path(converted_audio_dir, spk, src_file, tgt_spk)
                    if resume and os.path.exists(out):
                        continue
                    pred = batch_preds.get(src_file)
                    if pred is None:
                        pred = self.vocode(feats.out_feats_weighted, feats.shifted_query_f0,
                                           feats.harmonics_out_feats_weighted)
                    self._write(out, pred, tgt_loudness_db, written)
        return written


def knn_vc(ckpt_dir: str, ckpt_type: str = "mix", wavlm_ckpt: str | None = None,
           config_path: str | None = None, device: str | torch.device = "cuda") -> KnnSvc:
    """Factory of the reference's ddsp_hubconf.knn_vc(ckpt_type, local_ckpt_dir)."""
    return KnnSvc.load(ckpt_dir, ckpt_type, wavlm_ckpt, config_path, device=device)
