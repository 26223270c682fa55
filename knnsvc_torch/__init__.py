"""knnsvc_torch — the PyTorch/CUDA port of knnsvc_tpu for one NVIDIA H100.

The JAX package (knnsvc_tpu/) is the reference; this package mirrors its
module layout so each counterpart is easy to find, and imports nothing from
it. Plain tensor code is PyTorch; the two TPU kernels, gated-bias
attention and the concat-cost reselection, and the device f0 extractor's
Viterbi are hand-written CUDA kernels (csrc/, bound in ops/attention.py,
ops/concat_scan.py and ops/viterbi.py).

  io/        WAV codec (numpy), FLAC (native/flacdec over ctypes), loudness,
             torch .pt checkpoint converters, loader of the JAX package's
             parameter pytrees
  dsp/       linear and log-mel spectrograms, harmonic / sine excitation, f0
             (sidecars, native Harvest over ctypes, YIN, the device
             extractor)
  ops/       CUDA kernels, their nvcc build step, their plain PyTorch versions
  models/    WavLM encoder (and its streaming K/V-cache form), HiFi-GAN
             vocoder, its discriminators and GAN losses as nn.Modules
  match/     cosine kNN, f0 register shift and re-rank, concat-cost
             reselection and smoothness optimizer (post_opt), pools,
             serving core
  parallel/  device meshes (a grid of torch.devices, logical shards allowed),
             kNN and the whole match over a pool sharded on the mesh, the
             batch shardings and multi-process bring-up of training
  train/     vocoder fine-tuning: prematch, the training dataset, the GAN
             train step (MPD/MSD, AdamW; on one device, a data mesh, or
             processes joined by torch.distributed), the loop with its
             checkpoints; the spectral losses and the legacy DDSP dataset
  eval/      WER/CER, EER, pair lists, speaker similarity, intelligibility,
             golden-file regression, the demo site
  utils/     layer weightings, plots, FLOP counts (MFU), profiling
  cli/       ddsp_inference-compatible CLI (pair and folder mode, --fast,
             --stream_chunk_s), the prematch and train CLIs

Entry points (KnnSvc, KnnSvc.random_init, train, per_spk_extract,
initialize_distributed, the eval harnesses, the CLIs) run on device="cuda"
unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

HOP_LENGTH = 320          # WavLM frame hop in samples @ 16 kHz (ref ddsp_prematch_dataset.py:20)
SAMPLE_RATE = 16000
SPEAKER_INFORMATION_LAYER = 6  # matching/synthesis WavLM layer (ref ddsp_matcher.py:88)
