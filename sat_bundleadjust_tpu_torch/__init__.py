"""sat_bundleadjust_tpu_torch — satellite bundle adjustment for RPC model
refinement in PyTorch + CUDA.

A port of the JAX package `sat_bundleadjust_tpu` to PyTorch on an NVIDIA
Hopper card. `main(config_path)` (or `python -m
sat_bundleadjust_tpu_torch.cli config.json`) runs a scene config end to end
(`timeseries.Scene`, `pipeline.BundleAdjustmentPipeline`) and writes the JAX
package's outputs: rpcs_adj/*.rpc_adj, pts3d_adj.ply, cam_params/. It covers
* the tracks front end: SIFT detection (`ops.sift`), pair selection, the
  epipolar F init, 2-NN matching, RANSAC and the union-find tracks
  (`tracks.pipeline.FeatureTracksPipeline`); the 2-NN matchers and SIFT's
  scale-space blur and upsample are hand-written CUDA kernels
  (`ops.nn2_match`, `ops.sift`; sources `csrc/nn2_match.cu`,
  `csrc/sift_blur.cu`);
* the bundle-adjustment stage: the problem parameterization (`ba.params`),
  the Levenberg-Marquardt solve with the matrix-free CG Schur solver
  (`ops.lm`, `ba.solver`), outlier rejection with re-triangulation
  (`ba.outliers`, `ops.triangulate`) and the RPC geometry they run on
  (`models`); the CG operator is a hand-written CUDA kernel
  (`ops.schur_matvec`, source `csrc/schur_matvec.cu`);
* the refit of the adjusted RPCs (`ba.rpcfit`, batched f64 IRLS on the
  device), the RPC files, and the scene driver and its outputs;
* the options of the tracks front end (the opencv detector, AOI keypoint
  masks, DEM altitudes, the optional LightGlue matcher) and the side
  modules: the stereo helpers (`models.stereo`), the geoid grid
  (`utils.geoid`), profiling (`utils.profiling`) and `utils.vistools`.

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


def main(config_path, device=None):
    """Run the bundle adjustment of a json scene config on `device`
    (default: the card). Returns the Scene."""
    from sat_bundleadjust_tpu_torch.timeseries import Scene

    scene = Scene(config_path, device=device)
    scene.run_bundle_adjustment_for_RPC_refinement()
    return scene
