"""The control (the reference put in the program's place in bfloat16) and
the faults come out not correct; a sound run comes out correct.

The fault cases skip nothing but the harness's look for a card: they drive
a whole run on the CPU at a small size with the timed path broken
underneath, and see ``correct`` come out false."""

import dataclasses

import pytest
import torch

from conftest import SMALL
from portbench import control, harness

import distributionraytracer_tpu_torch.parallel.mesh as mesh
import distributionraytracer_tpu_torch.viewer as viewer
from distributionraytracer_tpu_torch.renderer import Renderer

def _control(cell, seed, device, overrides=None):
    """{reading: whether the cell's own Checks fail it}."""
    ctx = harness.Context(cell, seed, 0, 0, device=device,
                          overrides=overrides)
    return {r: not c.correct for r, c in control.readings(ctx).items()}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_at_a_small_size(cell):
    got = _control(cell, 2**35 + 1, "cpu", SMALL[cell])
    assert got and all(got.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_at_the_cells_size(cell, cuda_device):
    for seed in (3 * 2**31 + 1, 3 * 2**31 + 2, 3 * 2**31 + 3):
        got = _control(cell, seed, cuda_device)
        assert got and all(got.values()), (seed, got)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell, small_run):
    assert small_run(cell).checks.correct


def _frames_fault(monkeypatch, fault):
    """Break ``Renderer.render_with_samples`` underneath a frame run."""
    real = Renderer.render_with_samples
    first = []

    def broken(self, samples, return_rays=False):
        img = real(self, samples)
        if fault == "unchanged":  # every frame returns the first one
            first.append(img)
            return first[0]
        if fault == "half":  # the bottom half of the rows left out
            img = img.clone()
            img[: img.shape[0] // 2] = 0.0
            return img
        img = img.clone()  # an answer altered where it is produced
        img[:8, :8] += 0.25
        return img
    monkeypatch.setattr(Renderer, "render_with_samples", broken)


@pytest.mark.parametrize("cell", ["rtow.frame", "dragon.turntable"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_frame_is_not_correct(cell, fault, monkeypatch, small_run):
    _frames_fault(monkeypatch, fault)
    assert not small_run(cell, seconds=1.0).checks.correct


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(fault, monkeypatch, small_run):
    if fault == "unchanged":  # the step leaves the leaves as they were
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        real = mesh.l2_render_loss

        def broken(scene, cfg, samples, target, row_offset=0, inter=None):
            if fault == "altered":
                return real(scene, cfg, samples, target, row_offset,
                            inter) * 1.05
            h = target.shape[0] // 2  # the mean over half of the rows
            return real(scene, cfg, samples.rows(0, h), target[:h],
                        row_offset, inter)
        monkeypatch.setattr(mesh, "l2_render_loss", broken)
    assert not small_run("rtow.invert").checks.correct


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_request_is_not_correct(fault, monkeypatch, small_run):
    if fault == "unchanged":  # the accumulator never moves
        monkeypatch.setattr(Renderer, "progressive_step",
                            lambda self, state, generator: state)
    elif fault == "half":
        _frames_fault(monkeypatch, "half")
    else:
        real = viewer.png_bytes

        def broken(rgb):
            rgb = rgb.copy()
            rgb[:8, :8] ^= 0x40
            return real(rgb)
        monkeypatch.setattr(viewer, "png_bytes", broken)
    assert not small_run("rtow.view", seconds=1.0).checks.correct


def test_the_faults_do_not_leak(small_run):
    """After the patched cases, the program is whole again."""
    assert dataclasses.is_dataclass(harness.Checks) is False
    assert small_run("rtow.frame").checks.correct
