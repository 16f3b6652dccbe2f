"""The path-traced frame cell ``pt0.frame`` on the CPU at a small size:
a sound run is correct, a stale frame and the control's faults are not,
and its three per-layer readers read what a traced run hands them."""

import pytest

from portbench import harness, run

import distributionraytracer_tpu_torch.integrator.pathtracer as PT

SMALL = {"res_x": 32, "res_y": 24, "spp": 4,
         "params": {"check_pixels": 256}}


def _run(seconds=0.5, seed=2**33 + 5):
    ctx = harness.Context("pt0.frame", seed, seconds, 0, device="cpu",
                          overrides=SMALL)
    return run.run_cell(ctx)


def test_a_sound_run_is_correct():
    out = _run()
    assert out.checks.correct, out.checks.lines()
    assert set(out.checks.numbers()) == {
        "frame.bad_px", "frame.mean_abs", "frame.mean_gap"}
    assert set(out.end_to_end) == {"frame_ms", "setup_s"}


def test_a_stale_frame_is_not_correct(monkeypatch):
    real, first = PT.render_pt, []

    def stale(*args, **kw):  # every frame returns the first one
        first.append(real(*args, **kw))
        return first[0]
    monkeypatch.setattr(PT, "render_pt", stale)
    assert not _run(seconds=1.5).checks.correct


def test_the_control_and_its_faults_fail():
    from portbench import control_pt

    ctx = harness.Context("pt0.frame", 2**35 + 1, 0, 0, device="cpu",
                          overrides=SMALL)
    got = {r: c.correct for r, c in control_pt.readings(ctx).items()}
    assert set(got) == {"control", "no_boost", "one_bounce_fewer",
                        "stale_frame"}
    assert not (got["control"] or got["no_boost"] or got["stale_frame"])


NEW = ("kernel.k6_roofline", "pt.live_share.frame", "pt.host_ms.frame")


def _traced_obs():
    """A traced pt0.frame run's obs: a profile holding 4 ms of K6 a frame
    over 2 frames, a bound of 1 ms over them, and a program stretch."""
    prof = {"window_s": 0.3, "units": 2, "busy_s": 0.1,
            "device": {"pt_bounce_kernel(float const*, int)": [1180, 0.008],
                       "at::native::copy": [40, 0.002]},
            "launch_calls": {"cudaLaunchKernel": 2400}, "idle_gaps": {}}
    prog = {"unit": "frame", "units": 2, "counts": {
        "pt.paths": 76800000.0, "pt.paths_live": 19200000.0},
        "span_ms": {"pt.bounce": 61.5, "pt.frame": 90.0}}
    return {"unit": "frame", "unit_s": 0.1, "profile": prof,
            "k6_bound_s": 0.002, "program": prog}


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_read_a_traced_pt_run(name):
    got = harness.readers()[name].read(_traced_obs())
    assert got == {"kernel.k6_roofline": 25.0, "pt.live_share.frame": 0.25,
                   "pt.host_ms.frame": 61.5}[name]


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_read_nothing_in_another_cell(name):
    obs = _traced_obs()
    del obs["k6_bound_s"]
    obs["profile"]["device"] = {"whitted_level_kernel": [590, 0.035]}
    obs["program"] = {"unit": "frame", "units": 2, "counts": {
        "whitted.lanes": 4.0}, "span_ms": {"whitted.level": 3.0}}
    assert harness.readers()[name].read(obs) is None
    assert harness.readers()[name].read({"unit": "request"}) is None


def _python(code):
    import os
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_pt_reference_loads_nothing_of_the_program():
    import json

    code = (
        "import json, sys\n"
        "import portbench.control_pt, portbench.roofline_pt\n"
        "import portbench.reference.pt, portbench.reference.pt_scene\n"
        "import portbench.traffic.pt_frames\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
        " if m.split('.')[0].startswith(('distributionraytracer', 'jax',"
        " 'flax'))})))\n")
    assert json.loads(_python(code)) == []


def test_a_pt_run_loads_no_jax_and_no_jax_package():
    import json

    code = (
        "import json\n"
        "from portbench import harness, run\n"
        "ctx = harness.Context('pt0.frame', 2**40 + 9, 0.2, 0, device='cpu',"
        " overrides={'res_x': 16, 'res_y': 12, 'spp': 1,"
        " 'params': {'check_pixels': 64}})\n"
        "out = run.run_cell(ctx)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    assert json.loads(_python(code)) == []
