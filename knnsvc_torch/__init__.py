"""knnsvc_torch — the PyTorch/CUDA port of knnsvc_tpu for one NVIDIA H100.

The JAX package (knnsvc_tpu/) is the reference; this package mirrors its
module layout so each counterpart is easy to find, and imports nothing from
it. Plain tensor code is PyTorch; the one TPU kernel on the ported path,
gated-bias attention, is a hand-written CUDA kernel (csrc/, bound in
ops/attention.py).

  io/        WAV codec (numpy), loader of the JAX package's parameter pytrees
  dsp/       linear spectrogram, additive-harmonic / sine excitation, f0
             (sidecars, native Harvest over ctypes, YIN)
  ops/       CUDA kernels, their nvcc build step, their plain PyTorch versions
  models/    WavLM encoder and HiFi-GAN vocoder as nn.Modules
  match/     cosine kNN, f0 register shift and re-rank, pools, serving core
  cli/       ddsp_inference-compatible CLI (pair mode, --fast)

Entry points (KnnSvc, KnnSvc.random_init, the CLI) run on device="cuda"
unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

HOP_LENGTH = 320          # WavLM frame hop in samples @ 16 kHz (ref ddsp_prematch_dataset.py:20)
SAMPLE_RATE = 16000
SPEAKER_INFORMATION_LAYER = 6  # matching/synthesis WavLM layer (ref ddsp_matcher.py:88)
