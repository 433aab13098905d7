"""The port's four examples, each ``main`` at a small size on the CPU: their
own checks pass, and what they return and write is checked here against
float64 convolutions, the recorded golden and the files on disk."""

import pathlib

import numpy as np
import pytest

from fft_convolution_tpu_torch.examples import (compare_partitioned, reverb_farm, reverb_wav,
                                                serve_morph)
from fft_convolution_tpu_torch.utils.audio import load_wav, save_wav

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the reference's stream and golden tolerance (SURVEY §4, src/tests.rs:126)
ATOL = 1e-5
# 16-bit PCM: one step of i16::MAX
PCM_STEP = 1.0 / 32767


def _conv64(x, ir):
    return serve_morph.conv64(np.asarray(x, np.float64), np.asarray(ir, np.float64))


def test_compare_partitioned(tmp_path, capsys):
    res = compare_partitioned.main(["--device", "cpu", "--blocks", "100",
                                    "--outdir", str(tmp_path)])
    golden = np.load(ROOT / "tests" / "golden" / "compare_partitioned.npz")["y"]
    n = 100 * compare_partitioned.BLOCK_SIZE
    for key in ("output_a", "output_b"):
        assert res[key].shape == (n,) and res[key].dtype == np.float32
        np.testing.assert_allclose(res[key], golden[:n], atol=ATOL)
        back, rate = load_wav(str(tmp_path / f"{key}.wav"))
        assert rate == compare_partitioned.SAMPLE_RATE
        np.testing.assert_allclose(back, res[key], atol=PCM_STEP)
    assert res["max_abs_diff"] <= ATOL
    out = capsys.readouterr().out
    assert "Uniform took" in out and "Partitioned took" in out and "max_abs_diff" in out


@pytest.mark.parametrize("engine", ["uniform", "two_stage"])
def test_reverb_wav_synthetic(tmp_path, engine):
    out = tmp_path / "wet.wav"
    res = reverb_wav.main(["--device", "cpu", "--engine", engine, "--seconds", "1",
                           "--ir-seconds", "0.5", "--out", str(out)])
    dry, ir, wet = res["dry"], res["ir"], res["wet"]
    assert type(wet) is np.ndarray and wet.shape == dry.shape
    ref = _conv64(dry, ir)
    np.testing.assert_allclose(wet, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))
    back, rate = load_wav(str(out))
    assert rate == 48000
    np.testing.assert_allclose(back, res["mix"], atol=PCM_STEP)


def test_reverb_wav_from_files(tmp_path):
    """WAV in, wet mix out: the dry signal and the IR as 16-bit files."""
    rng = np.random.default_rng(3)
    dry = (rng.standard_normal(7000) * 0.2).clip(-1, 1).astype(np.float32)
    ir = (rng.standard_normal(3000) * 0.05).clip(-1, 1).astype(np.float32)
    save_wav(str(tmp_path / "dry.wav"), dry, 44100)
    save_wav(str(tmp_path / "ir.wav"), ir, 44100)
    res = reverb_wav.main(["--device", "cpu", "--in", str(tmp_path / "dry.wav"),
                           "--ir", str(tmp_path / "ir.wav"), "--out", str(tmp_path / "w.wav"),
                           "--block", "64"])
    assert res["sample_rate"] == 44100 and res["wet"].shape == (7000,)
    dry_q, _ = load_wav(str(tmp_path / "dry.wav"))
    ir_q, _ = load_wav(str(tmp_path / "ir.wav"))
    np.testing.assert_allclose(res["wet"], _conv64(dry_q, ir_q), atol=ATOL)


def test_reverb_farm(capsys):
    res = reverb_farm.main(["--device", "cpu", "--voices", "2", "--ir-seconds", "1"])
    assert res["err"] <= reverb_farm.TOL
    assert res["y"].shape == (res["T"], 2, reverb_farm.BLOCK)
    assert np.isfinite(res["y"]).all()
    assert "voice 0 vs standalone engine" in capsys.readouterr().out


def test_serve_morph(tmp_path):
    wav = tmp_path / "morph.wav"
    res = serve_morph.main(["--device", "cpu", "--blocks", "96", "--wav", str(wav)])
    assert res["blocks"] == 96 and res["y"].shape == (96 * serve_morph.BLOCK,)
    assert 0 < res["update_applied_at"] < 96
    assert res["pre_err"] <= serve_morph.TOL and res["post_err"] <= serve_morph.TOL
    assert res["pre_window"][1] == res["update_applied_at"] * serve_morph.BLOCK
    back, _ = load_wav(str(wav))
    inside = np.abs(res["y"]) < 1  # 16-bit PCM holds [-1, 1]
    assert back.shape == res["y"].shape and inside.mean() > 0.5
    np.testing.assert_allclose(back[inside], res["y"][inside], atol=PCM_STEP)
