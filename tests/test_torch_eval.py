"""knnsvc_torch's eval harnesses on the CPU against the JAX package's:
WER/CER measures, number words and EER exactly (the port's numpy ROC
against scikit-learn's, which the JAX package calls), the pair lists and
score comparisons byte for byte, speaker similarity with
mfcc_stats_embedder (embeddings within 1e-4, EERs equal), the
intelligibility harness with a stub transcriber, the regression metrics
(spectral distance at 1e-5) and the demo site."""

import csv
import functools

import numpy as np
import pytest

from test_torch_common import one_torch_thread  # noqa: F401  (autouse)

SR = 16000
TEXTS = [("The cat sat on the mat, 2 times!", "the cat sat on a mat two times"),
         ("Hello world", "hello word world"), ("chapter 115 begins", "chapter one fifteen"),
         ("", "stray words"), ("a b c d", "a x b c"), ("year 1984 came", "year 1984 came")]


def test_measures_and_number_words_equal_jax():
    from knnsvc_tpu.eval import metrics as jm
    from knnsvc_torch.eval import cer, compute_measures, numbers_to_words, wer

    truths, hyps = zip(*TEXTS)
    for unit in ("words", "chars"):
        assert compute_measures(list(truths), list(hyps), unit) == \
            jm.compute_measures(list(truths), list(hyps), unit)
    for t, p in TEXTS:
        assert wer([t], [p]) == jm.wer([t], [p]) and cer([t], [p]) == jm.cer([t], [p])
        assert numbers_to_words(t) == jm.numbers_to_words(t)
    for n in (0, 7, 19, 20, 99, 100, 101, 115, 999, 1000, 1001, 12345, 10 ** 6 + 5, 2 * 10 ** 9):
        assert numbers_to_words(str(n)) == jm.numbers_to_words(str(n))


@pytest.mark.parametrize("case", ["separable", "random", "ties", "small"])
def test_eer_and_roc_equal_scikit_learn(case):
    from sklearn.metrics import roc_curve as sk_roc

    from knnsvc_tpu.eval.metrics import eer as jax_eer
    from knnsvc_torch.eval.metrics import eer, roc_curve

    rng = np.random.default_rng(8)
    labels = np.array([1] * 40 + [0] * 40)
    scores = {"separable": np.r_[rng.random(40) * 0.3, 0.6 + rng.random(40) * 0.3],
              "random": rng.random(80),
              "ties": np.round(rng.random(80), 1)}.get(case)
    if case == "small":
        labels, scores = np.array([0, 1, 0, 1, 1, 0]), np.array([0.3, 0.1, 0.3, 0.7, 0.2, 0.5])
    for got, want in zip(roc_curve(labels, 1 - scores), sk_roc(labels, 1 - scores, pos_label=1)):
        np.testing.assert_array_equal(got, want)
    assert eer(labels, scores) == jax_eer(labels, scores)


@pytest.fixture(scope="module")
def speakers(tmp_path_factory):
    """Two synthetic singers x 3 utterances, pair lists from both packages,
    and converted outputs in the <utt>/<tgt_spk> layout."""
    from knnsvc_tpu.eval.pairs import generate_pair_lists as jax_pairs
    from knnsvc_torch.eval.pairs import generate_pair_lists
    from knnsvc_torch.io.audio import save_audio

    from test_torch_common import vibrato_wav

    root = tmp_path_factory.mktemp("speakers")
    gt = root / "gt"
    for spk, hz in (("spkA", 200.0), ("spkB", 420.0)):
        (gt / spk).mkdir(parents=True)
        for i in range(3):
            save_audio(gt / spk / f"{spk}_utt{i}.wav", vibrato_wav(0.8, hz + 7 * i, 60 + i), SR)
    ours = generate_pair_lists(str(gt), str(gt), str(root / "splits"), seed=3)
    theirs = jax_pairs(str(gt), str(gt), str(root / "jax_splits"), seed=3)
    conv = root / "converted"
    with open(ours[0]) as fh:
        for src, tgt, x_path, _, label in list(csv.reader(fh))[1:]:
            if label == "0":
                (conv / x_path).parent.mkdir(parents=True, exist_ok=True)
                hz = 205.0 if tgt == "spkA" else 410.0
                save_audio(conv / f"{x_path}.wav", vibrato_wav(0.7, hz, len(x_path)), SR)
    return root, gt, conv, ours, theirs


def test_pair_lists_and_score_diffs_equal_jax(speakers):
    from knnsvc_tpu.eval.pairs import compare_score_csvs as jax_compare
    from knnsvc_torch.eval.pairs import compare_score_csvs

    root, _, _, ours, theirs = speakers
    for a, b in zip(ours, theirs):
        assert open(a).read() == open(b).read()
    assert len(open(ours[0]).read().splitlines()) == 1 + 2 * 3 * 2
    header = ",src_speaker,tgt_speaker,src_path,tgt_path,score,label\n"
    (root / "a.csv").write_text(header + "".join(f"{i},s,t,x{i},y{i},{0.1 * i},0\n"
                                                 for i in range(6)))
    (root / "b.csv").write_text(header + "".join(f"{i},s,t,x{i},y{i},{0.5 - 0.13 * i},0\n"
                                                 for i in range(6)))
    args = (str(root / "a.csv"), str(root / "b.csv"))
    assert compare_score_csvs(*args, k=2) == jax_compare(*args, k=2)


def test_speaker_similarity_matches_jax(speakers):
    from knnsvc_tpu.eval.speaker_sim import compute_speaker_similarity as jax_sim
    from knnsvc_tpu.eval.speaker_sim import mfcc_stats_embedder as jax_embed
    from knnsvc_torch.eval.speaker_sim import compute_speaker_similarity, mfcc_stats_embedder
    from knnsvc_torch.io.audio import load_audio

    root, gt, conv, (sim_csv, _), _ = speakers
    wav = load_audio(gt / "spkA" / "spkA_utt0.wav")[0][0]
    np.testing.assert_allclose(mfcc_stats_embedder(wav, device="cpu"), jax_embed(wav), atol=1e-4)
    (root / "res").mkdir()
    (root / "jax_res").mkdir()
    got = compute_speaker_similarity(sim_csv, str(conv), str(gt),
                                     functools.partial(mfcc_stats_embedder, device="cpu"),
                                     result_dir=str(root / "res"))
    want = jax_sim(sim_csv, str(conv), str(gt), result_dir=str(root / "jax_res"))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    assert list(got.index) == list(want.index) == ["mean", "std"]
    rows = [list(csv.reader(open(d / "converted_sim_result.txt")))
            for d in (root / "res", root / "jax_res")]
    assert [r[:5] + r[6:] for r in rows[0]] == [r[:5] + r[6:] for r in rows[1]]
    np.testing.assert_allclose([float(r[5]) for r in rows[0][1:]],
                               [float(r[5]) for r in rows[1][1:]], atol=1e-5)


def test_intelligibility_harness_matches_jax(tmp_path):
    from knnsvc_tpu.eval.intelligibility import evaluate_intelligibility as jax_eval
    from knnsvc_torch.eval.intelligibility import evaluate_intelligibility
    from knnsvc_torch.io.audio import save_audio

    root = tmp_path / "ls" / "clean" / "19" / "198"
    root.mkdir(parents=True)
    texts = {"19-198-0000": "HELLO WORLD", "19-198-0001": "TWO CATS SAT 3 TIMES",
             "19-198-0002": "NOT IN THE SUBSET"}
    with open(root / "19-198.trans.txt", "w") as fh:
        for utt, text in texts.items():
            save_audio(root / f"{utt}.wav", np.zeros(1600, np.float32), SR)
            fh.write(f"{utt} {text}\n")
    subset = tmp_path / "subset.txt"
    subset.write_text("19-198-0000\n19-198-0001\n")
    pred = tmp_path / "converted"
    for utt in texts:
        for tgt in ("spkX", "spkY"):
            (pred / "19" / utt).mkdir(parents=True, exist_ok=True)
            save_audio(pred / "19" / utt / f"{tgt}.wav", np.zeros(1600, np.float32), SR)
    asr = lambda path: ("HELLO WORLD" if "0000" in path  # noqa: E731
                        else "TWO DOGS SAT THREE TIMES" if "spkX" in path else "TO CATS SAT")
    outs = []
    for fn, name in ((evaluate_intelligibility, "ours"), (jax_eval, "jax")):
        (tmp_path / name).mkdir()
        outs.append(fn(str(tmp_path / "ls"), str(subset), str(pred), asr,
                       result_dir=str(tmp_path / name)))
    got, want = outs
    assert got["wer"] == want["wer"] and got["cer"] == want["cer"]
    assert got["wer"]["wer"] > 0 and got["wer"]["hits"] > 0
    assert open(got["result_file"]).read() == open(want["result_file"]).read()


def test_regression_metrics_match_jax(speakers):
    from knnsvc_tpu.eval import regression as jr
    from knnsvc_torch.eval.regression import max_waveform_deviation, spectral_distance

    _, gt, _, _, _ = speakers
    a, b = str(gt / "spkA" / "spkA_utt0.wav"), str(gt / "spkA" / "spkA_utt1.wav")
    assert max_waveform_deviation(a, b) == jr.max_waveform_deviation(a, b) > 0
    assert max_waveform_deviation(a, a) == 0.0
    np.testing.assert_allclose(spectral_distance(a, b, device="cpu"), jr.spectral_distance(a, b),
                               rtol=1e-5, atol=1e-5)
    assert spectral_distance(a, a, device="cpu") == 0.0


def test_demo_site_equals_jax(speakers, tmp_path):
    from knnsvc_tpu.eval.demo_site import build_demo_page as jax_page
    from knnsvc_tpu.eval.demo_site import duration_ablation_section as jax_section
    from knnsvc_torch.eval.demo_site import build_demo_page, duration_ablation_section

    _, gt, _, _, _ = speakers
    w = [str(p) for p in sorted(gt.rglob("*.wav"))]
    pages = []
    for page, section, name in ((build_demo_page, duration_ablation_section, "ours"),
                                (jax_page, jax_section, "jax")):
        sections = [("comparison <a&b>", ["", "src", "ref", "row1", w[0], w[1]], 3),
                    section(w[0], w[1], {"5s": w[2], "full": w[3]})]
        out = page(sections, str(tmp_path / name), title="demo")
        pages.append(open(out).read())
        assert (tmp_path / name / "assets" / "spkA_utt0.wav").exists()
    assert pages[0] == pages[1] and pages[0].count("<audio controls") == 6
