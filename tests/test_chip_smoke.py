"""chip_smoke.py at tiny sizes on the CPU: every phase runs and computes
its gates, the script refuses a non-GPU platform, its last line carries
exactly the contract's keys, ``--four`` selects only the sharded phase,
and the compile cache lands where it should."""
import json
import math

import jax
import pytest

import chip_smoke
from bench import common as bench_common
from ionotomo_tpu.utils import compile_cache


def _gates_computed(rec):
    assert rec["gates"], rec
    for name, g in rec["gates"].items():
        assert math.isfinite(g["value"]), (name, g)
        assert isinstance(g["ok"], bool)


def test_field_models_phase_meets_precision_bounds():
    rec = chip_smoke.phase_field_models(0, n=16, n_points=64)
    _gates_computed(rec)
    assert {f"{m}_grad_err" for m in ("cubic", "zp", "zpc")} <= set(
        rec["gates"])
    # exact f32 contractions on the CPU sit well inside PRECISION.md's
    # bounds; only a lower-precision contraction could break them
    assert all(g["ok"] for g in rec["gates"].values()), rec["gates"]


def test_tracer_phase_reports_rates_and_oracle_gates():
    rec = chip_smoke.phase_tracer(0, n=16, n_rays=64, n_steps=16,
                                  n_oracle=2, reps=1)
    _gates_computed(rec)
    assert set(rec["models"]) == {"zp", "cubic"}
    assert all(v["rays_per_s"] > 0 for v in rec["models"].values())
    assert "cubic_60mhz_endpoint_m" in rec["gates"]
    assert rec["gates"]["zp_nonfinite_tec"]["ok"]


def test_snapshot_phase_runs_both_grids(tmp_path):
    rec = chip_smoke.phase_snapshot(0, str(tmp_path), n=12, n_big=16,
                                    n_ants=8, n_dirs=6)
    _gates_computed(rec)
    assert set(rec["solves"]) == {12, 16}
    assert rec["gates"]["12_residual_reduction"]["ok"]


def test_filters_phase_resumes_bit_identically_on_cpu(tmp_path):
    rec = chip_smoke.phase_filters(0, str(tmp_path), n=12, n_ants=8,
                                   n_dirs=4, kalman_epochs=2,
                                   enkf_epochs=2, members=2,
                                   resume_epochs=2)
    _gates_computed(rec)
    # the CPU's reductions are ordered: resume must be exact there
    assert rec["runs"]["resume"]["max_abs_diff"] == 0.0
    assert rec["gates"]["kalman_mean_residual_reduction"]["ok"]


def test_streaming_phase_assimilates_every_epoch():
    rec = chip_smoke.phase_streaming(0, n=12, n_ants=8, n_dirs=4,
                                     n_epochs=2)
    _gates_computed(rec)
    assert rec["gates"]["mean_residual_reduction"]["ok"]
    assert len(rec["seconds_per_epoch"]) == 2


def test_four_phase_matches_one_device_on_four_cpu_devices():
    rec = chip_smoke.phase_four(0, n=12, n_ants=8, n_dirs=4,
                                n_trace_rays=16, n_trace_steps=8,
                                members=4, epochs=2, cg_iters=5)
    _gates_computed(rec)
    assert all(g["ok"] for g in rec["gates"].values()), rec["gates"]


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_platform_check_refuses_cpu(monkeypatch, capsys, argv):
    monkeypatch.setattr(bench_common, "card_lines", lambda: ["fake, 1 W"])
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert "needs a GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


class _Dev:
    platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"


def test_contract_line_has_exactly_the_contract_keys():
    got = json.loads(chip_smoke.contract_line([_Dev()] * 4))
    assert got == {"ok": True, "device": {"platform": "gpu",
                                          "kind": "NVIDIA H100 80GB HBM3",
                                          "count": 4}}


@pytest.mark.parametrize("four", [False, True])
def test_four_option_selects_only_the_sharded_phase(monkeypatch, capsys,
                                                    tmp_path, four):
    ran = []

    def fake(name):
        def phase(*args, **kw):
            ran.append(name)
            return dict(phase=name, gates={"x": chip_smoke.gate(0, "<=", 1)})
        return phase

    for name in ("field_models", "tracer", "snapshot", "filters",
                 "streaming", "four"):
        monkeypatch.setattr(chip_smoke, f"phase_{name}", fake(name))
    monkeypatch.setattr(chip_smoke, "device_record", lambda: dict(
        device_count=4, cards=["fake, 1 W"], device_kind="kind"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: str(tmp_path))
    chip_smoke.main(["--four"] if four else [])
    assert ran == (["four"] if four else
                   ["field_models", "tracer", "snapshot", "filters",
                    "streaming"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "fake, 1 W"
    assert set(json.loads(lines[-1])) == {"ok", "device"}


def test_failed_gate_is_fatal_and_prints_no_contract_line(capsys):
    rec = dict(phase="p", gates={"g": chip_smoke.gate(float("nan"), "<=",
                                                      1.0)})
    with pytest.raises(SystemExit):
        chip_smoke.emit(rec, ["fake, 1 W"], "kind")
    out = capsys.readouterr().out
    assert json.loads(out)["gates"]["g"]["ok"] is False


def test_compile_cache_dir_env_or_checkout(monkeypatch, tmp_path):
    env_dir = str(tmp_path / "cache")
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: env_dir}) \
        == env_dir
    assert compile_cache.cache_dir({}) == str(
        compile_cache.CHECKOUT / ".jax_cache")
    assert (compile_cache.CHECKOUT / "chip_smoke.py").exists()

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    assert compile_cache.enable_compile_cache() == env_dir
    assert updates == []           # JAX reads the variable itself
    monkeypatch.delenv(compile_cache.ENV_VAR)
    path = compile_cache.enable_compile_cache()
    assert updates == [("jax_compilation_cache_dir", path)]
    assert path.endswith(".jax_cache")
