"""CLI round-trip: simulate → info → invert → info."""
import subprocess
import sys
import os


def run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "ionotomo_tpu", *args],
                          capture_output=True, text=True, cwd=cwd, env=env)


def test_cli_simulate_invert_info(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    obs = tmp_path / "obs.h5"
    sol = tmp_path / "sol.h5"
    r = run(["simulate", "--out", str(obs), "--antennas", "8",
             "--directions", "4", "--grid", "14"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    assert obs.exists()

    r = run(["info", str(obs)], repo)
    assert r.returncode == 0
    assert "antennas: 8" in r.stdout

    r = run(["invert", str(obs), "--out", str(sol), "--grid", "14",
             "--samples", "17", "--cg-iters", "8", "--gn-iters", "1",
             "--checkpoint-dir", str(tmp_path / "ckpt"),
             "--metrics", str(tmp_path / "m.jsonl")], repo)
    assert r.returncode == 0, r.stderr[-500:]
    assert sol.exists()

    r = run(["info", str(sol)], repo)
    assert r.returncode == 0
    assert "timesteps: 1" in r.stdout


def test_cli_predict_roundtrip(tmp_path):
    """simulate → invert → predict: the prediction must fit the observed
    dtec better than a zero model, and --rm must add the drm dataset."""
    import h5py
    import numpy as np

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    obs = tmp_path / "obs.h5"
    sol = tmp_path / "sol.h5"
    pred = tmp_path / "pred.h5"
    r = run(["simulate", "--out", str(obs), "--antennas", "8",
             "--directions", "4", "--grid", "14"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    r = run(["invert", str(obs), "--out", str(sol), "--grid", "14",
             "--samples", "17", "--cg-iters", "10", "--gn-iters", "2",
             "--checkpoint-dir", str(tmp_path / "ckpt"),
             "--metrics", str(tmp_path / "m.jsonl")], repo)
    assert r.returncode == 0, r.stderr[-500:]
    r = run(["predict", str(sol), str(obs), "--out", str(pred),
             "--samples", "17", "--rm"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    assert "residual rms" in r.stdout
    with h5py.File(obs) as fo, h5py.File(pred) as fp:
        d_obs = fo["dtec"][:]
        d_pred = fp["dtec"][:]
        assert d_pred.shape == d_obs.shape
        # prediction explains most of the observed signal
        assert (np.sqrt(np.mean((d_pred - d_obs) ** 2))
                < 0.6 * np.sqrt(np.mean(d_obs ** 2)))
        drm = fp["drm"][:]
        assert drm.shape == d_obs.shape
        assert np.isfinite(drm).all()
        # dRM vanishes at the reference antenna row
        i0 = int(fp.attrs["ref_antenna"])
        np.testing.assert_allclose(drm[i0], 0.0, atol=1e-7)

    # bent prediction: same paired forward over the traced bundle — at
    # 150 MHz it must agree closely with the straight-ray prediction
    pred_b = tmp_path / "pred_bent.h5"
    r = run(["predict", str(sol), str(obs), "--out", str(pred_b),
             "--bent", "--n-steps", "16", "--rm"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    with h5py.File(pred) as fs, h5py.File(pred_b) as fb:
        ds, db = fs["dtec"][:], fb["dtec"][:]
        assert np.isfinite(db).all()
        scale = np.abs(ds).max()
        assert np.abs(db - ds).max() < 0.05 * scale
        assert np.isfinite(fb["drm"][:]).all()


def test_cli_serve_and_h5parm_predict(tmp_path):
    """serve assimilates dropped epoch files; predict --h5parm emits a
    soltab that info recognises and from_h5parm reloads."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    # epoch files via the simulate CLI (different times)
    for i in range(2):
        r = run(["simulate", "--out", str(watch / f"e{i}.h5"),
                 "--antennas", "6", "--directions", "3", "--grid", "12",
                 "--times", "1",
                 "--mjd0", str(58000.45 + i * 30.0 / 86400.0)], repo)
        assert r.returncode == 0, r.stderr[-500:]
    r = run(["serve", str(watch), str(out), "--grid", "14",
             "--samples", "17", "--cg-iters", "6", "--max-epochs", "2",
             "--prior-kind", "sqexp"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    assert "assimilated 2 epoch(s)" in r.stdout
    assert (out / "epoch_000001.h5").exists()

    # h5parm output from predict on the served solution
    pred = tmp_path / "pred.h5"
    r = run(["predict", str(out / "epoch_000001.h5"),
             str(watch / "e1.h5"), "--out", str(pred), "--samples", "17",
             "--h5parm"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    r = run(["info", str(pred)], repo)
    assert r.returncode == 0 and "h5parm" in r.stdout
    from ionotomo_tpu.data.datapack import DataPack
    assert DataPack.from_h5parm(pred).shape == (6, 1, 3)


def test_cli_simulate_soundings_streamed_into_serve(tmp_path):
    """simulate --ionosonde-out writes synthetic bottomside soundings of
    the truth world; dropped into a serve watch dir as *.sounding.npz
    they are assimilated live and recorded in the diagnostics stream."""
    import json

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    watch = tmp_path / "in"; watch.mkdir()
    out = tmp_path / "out"
    for i in range(2):
        r = run(["simulate", "--out", str(watch / f"e{i}.h5"),
                 "--antennas", "6", "--directions", "3", "--grid", "12",
                 "--times", "1",
                 "--mjd0", str(58000.45 + i * 30.0 / 86400.0)], repo)
        assert r.returncode == 0, r.stderr[-500:]
    r = run(["simulate", "--out", str(tmp_path / "unused.h5"),
             "--antennas", "6", "--directions", "3", "--grid", "12",
             "--ionosonde-out", str(watch / "s0.sounding.npz"),
             "--ionosonde-stations", "2"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    assert "synthetic ionosonde probe(s)" in r.stdout

    r = run(["serve", str(watch), str(out), "--grid", "14",
             "--samples", "17", "--cg-iters", "6", "--max-epochs", "2",
             "--prior-kind", "sqexp"], repo)
    assert r.returncode == 0, r.stderr[-500:]
    recs = [json.loads(l) for l in open(out / "epochs.jsonl")]
    snd = [x for x in recs if x.get("event") == "sounding"]
    assert len(snd) == 1 and snd[0]["file"] == "s0.sounding.npz", recs
