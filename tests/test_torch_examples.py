"""The port's demo (examples/synthetic_demo_torch.py) against the JAX
package's (examples/synthetic_demo.py), on the CPU: the same scene
directory from the same seeds."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_scene_dir_matches_the_jax_demo(tmp_path):
    """build_scene_dir: the same 4 file names, .rpc files equal as text (the
    biases come from the same RandomState(7), the RPCs are numpy in both),
    and the same uint8 images (the renders agree to 1e-6 before the
    truncation to uint8; measured: equal)."""
    jdir = _load("synthetic_demo").build_scene_dir(str(tmp_path / "jax"))
    tdir = _load("synthetic_demo_torch").build_scene_dir(str(tmp_path / "torch"), device="cpu")
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and len(names) == 8
    for name in names:
        if name.endswith(".rpc"):
            with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
                assert a.read() == b.read(), name
        else:
            a = np.asarray(Image.open(os.path.join(jdir, name)))
            b = np.asarray(Image.open(os.path.join(tdir, name)))
            assert a.shape == (300, 400) and a.dtype == np.uint8
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_demo_asks_for_the_card(tmp_path):
    """Without device=, the demo renders on the card: where CUDA is not
    available it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    demo = _load("synthetic_demo_torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.build_scene_dir(str(tmp_path))
