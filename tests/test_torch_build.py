"""The kernel build (``ops/build.py``) without a CUDA toolkit: a failed
compile raises and leaves nothing in the build directory."""

import os
import stat

import pytest
import torch

from distributionraytracer_tpu_torch.ops import build

torch.set_num_threads(1)


def test_failed_build_raises_and_leaves_no_objects(tmp_path, monkeypatch):
    """A stand-in nvcc writes its output for every source but pt.cu, whose
    compile fails: the other objects are removed all the same."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\ncase "$*" in *pt.cu*) exit 3;; esac\n'
                    'for a; do last=$a; done\n: > "$last"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    out = tmp_path / "_build"
    monkeypatch.setattr(build, "_find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"nvcc failed \(3\)"):
            build.load()
    finally:
        build.load.cache_clear()
    assert os.listdir(out) == []
