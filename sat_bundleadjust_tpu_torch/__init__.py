"""sat_bundleadjust_tpu_torch — the tracks front end and the bundle-adjustment
stage in PyTorch + CUDA.

A port of the JAX package `sat_bundleadjust_tpu` to PyTorch on an NVIDIA
Hopper card. It covers
* the tracks front end: SIFT detection (`ops.sift`), pair selection, the
  epipolar F init, 2-NN matching, RANSAC and the union-find tracks
  (`tracks.pipeline.FeatureTracksPipeline`); the 2-NN matchers are
  hand-written CUDA kernels (`ops.nn2_match`, source `csrc/nn2_match.cu`);
* the bundle-adjustment stage: the problem parameterization (`ba.params`),
  the Levenberg-Marquardt solve with the matrix-free CG Schur solver
  (`ops.lm`, `ba.solver`), outlier rejection with re-triangulation
  (`ba.outliers`, `ops.triangulate`) and the RPC geometry they run on
  (`models`); the CG operator is a hand-written CUDA kernel
  (`ops.schur_matvec`, source `csrc/schur_matvec.cu`).

Conventions:
* entry points take `device=`; the default is the CUDA card, and asking for
  it on a host without CUDA raises instead of running on the CPU;
* geometry and LM state are float64; Jacobians, normal equations and the
  CG inner solve are float32;
* random numbers come from numpy so that scenes built from one seed match
  the JAX package's.

The package never imports `jax` or `sat_bundleadjust_tpu`.
"""

import torch

# The CG operator must be exact to f32: a reduced-precision fold of the
# folded Schur blocks stalls the solve. TF32 is off for every matmul.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """The device an entry point runs on: `device`, or the CUDA card.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and is not available — the port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
