"""Intelligibility (WER/CER) evaluation harness (counterpart of
knnsvc_tpu/eval/intelligibility.py).

Protocol == ref data_splits/eval_intelligibility.py: for each source
utterance in the subset list, transcribe every converted file derived from it
(output tree `<pred_path>/<src_spk>/<utt>/<tgt_spk>.wav`), normalize numbers
to words, clean text, and report corpus WER + CER; writes
`<pred_path basename>_result.txt`.

ASR backend: pluggable `transcribe_fn(path) -> str`. The default builds a
transformers Whisper model from `--asr_model`, a local checkpoint directory
(nothing is downloaded), on `--device` (the card by default); or pass your
own callable.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Callable

import numpy as np
import pandas as pd

from knnsvc_torch.eval.metrics import compute_measures, numbers_to_words


def make_librispeech_df(root_path: Path) -> pd.DataFrame:
    """(ref :45-51) speaker ids 'ls-<id>' from LibriSpeech-style filenames."""
    all_files = list(root_path.rglob("**/*.flac")) + list(root_path.rglob("**/*.wav"))
    speakers = ["ls-" + f.stem.split("-")[0] for f in all_files]
    subset = [f.parents[2].stem if len(f.parents) > 2 else "" for f in all_files]
    return pd.DataFrame({"path": all_files, "speaker": speakers, "subset": subset})


def attach_transcriptions(df: pd.DataFrame, librispeech_layout: bool = True) -> pd.DataFrame:
    """LibriSpeech `.trans.txt` (ref :53-72) or per-file `.txt` sidecars
    (ref :76-93, the OpenSinger/Mandarin branch)."""
    out = []
    cache: dict[str, str] = {}
    for _, row in df.iterrows():
        p = Path(row.path)
        if librispeech_layout:
            if p.stem not in cache:
                trans = p.parent / ("-".join(p.stem.split("-")[:2]) + ".trans.txt")
                with open(trans) as fh:
                    for line in fh:
                        utt_id, text = line.split(" ", maxsplit=1)
                        cache[utt_id] = text.strip()
            out.append(cache[p.stem])
        else:
            txt = str(p).rsplit(".", 1)[0] + ".txt"
            with open(txt) as fh:
                lines = fh.readlines()
            assert len(lines) == 1
            out.append(lines[0].strip())
    df = df.copy()
    df["transcription"] = out
    return df


def default_whisper_transcriber(model_path: str, language: str = "english",
                                beam_size: int = 20,
                                device: str = "cuda") -> Callable[[str], str]:
    """transformers Whisper from a local checkpoint directory, on `device`
    (the reference uses openai-whisper with beam 20 and a temperature ladder
    — ref :24-34; transformers' beam search is the equivalent here)."""
    import torch

    from knnsvc_torch.hub import resolve_device
    from knnsvc_torch.io.audio import load_audio, to_mono

    dev = resolve_device(device)
    if not os.path.isdir(model_path):
        raise FileNotFoundError(f"{model_path}: a local Whisper checkpoint directory "
                                "(nothing is downloaded)")
    from transformers import WhisperForConditionalGeneration, WhisperProcessor

    processor = WhisperProcessor.from_pretrained(model_path, local_files_only=True)
    model = WhisperForConditionalGeneration.from_pretrained(
        model_path, local_files_only=True).to(dev).eval()

    def transcribe(path: str) -> str:
        x, sr = load_audio(path)
        x = to_mono(x)[0]
        inputs = processor(x, sampling_rate=sr, return_tensors="pt")
        with torch.no_grad():
            ids = model.generate(inputs.input_features.to(dev), num_beams=beam_size,
                                 language=language, task="transcribe")
        return processor.batch_decode(ids, skip_special_tokens=True)[0].strip().upper()

    return transcribe


def evaluate_intelligibility(
    librispeech_path: str,
    source_uttrs_file: str,
    pred_path: str,
    transcribe_fn: Callable[[str], str],
    librispeech_layout: bool | None = None,
    result_dir: str | None = None,
) -> dict:
    """Returns {'wer': measures, 'cer': measures} and writes the result txt
    (ref :211-216)."""
    root = Path(librispeech_path)
    if librispeech_layout is None:
        librispeech_layout = any(root.rglob("*.trans.txt"))
    ls_df = attach_transcriptions(make_librispeech_df(root), librispeech_layout)

    with open(source_uttrs_file) as fh:
        items = [line.strip() for line in fh if line.strip()]
    mask = np.array([any(it in str(p) for it in items) for p in ls_df["path"]])
    ls_df = ls_df[mask]

    gt_transcripts, pred_transcripts = [], []
    for _, row in ls_df.iterrows():
        utt = Path(row.path).stem
        # converted files live at <pred_path>/<src_spk>/<utt>/<tgt>.<ext>
        conv_dir_matches = list(Path(pred_path).glob(f"*/{utt}/*"))
        for cpath in conv_dir_matches:
            if cpath.suffix.lower() not in (".wav", ".flac", ".mp3"):
                continue
            pred_transcripts.append(transcribe_fn(str(cpath)))
            gt_transcripts.append(row.transcription)

    gt_transcripts = [numbers_to_words(t) for t in gt_transcripts]
    pred_transcripts = [numbers_to_words(t) for t in pred_transcripts]

    wer_m = compute_measures(gt_transcripts, pred_transcripts, "words")
    cer_m = compute_measures(gt_transcripts, pred_transcripts, "chars")

    out_dir = result_dir or os.path.dirname(os.path.abspath(pred_path))
    result_file = os.path.join(out_dir, f"{os.path.basename(pred_path)}_result.txt")
    with open(result_file, "w") as fh:
        print(str(pred_path), file=fh)
        print("\nWER measure\n", file=fh)
        print(str(wer_m), file=fh)
        print("\nCER measure\n", file=fh)
        print(str(cer_m), file=fh)
    return {"wer": wer_m, "cer": cer_m, "result_file": result_file}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Compute WER/CER of converted audio.")
    parser.add_argument("--librispeech_path", required=True, type=str)
    parser.add_argument("--source_uttrs", required=True, type=str)
    parser.add_argument("--pred_path", required=True, type=str)
    parser.add_argument("--asr_model", required=True, type=str,
                        help="local directory of a transformers Whisper checkpoint")
    parser.add_argument("--language", default="english", type=str)
    parser.add_argument("--beam", default=20, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    fn = default_whisper_transcriber(args.asr_model, args.language, args.beam, args.device)
    result = evaluate_intelligibility(
        args.librispeech_path, args.source_uttrs, args.pred_path, fn
    )
    print("-" * 10 + " WER " + "-" * 10)
    print(result["wer"]["wer"])
    print("-" * 10 + " CER " + "-" * 10)
    print(result["cer"]["wer"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
