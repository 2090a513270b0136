"""The port's distributed solve (parallel/dist_solver.py) on two gloo ranks
on the CPU, against the JAX package's run_distributed_ba on a 2-device
mesh and against the port's own one-device CG solve.

Problems (the port's utils/demo.py, numpy from one seed): rpc cameras
with correction_params R (P = 3), and affine cameras with R, T, K and
COMMON_K (P = 8, the tied-tail projector). A fixed iteration budget (ftol
= xtol = 1e-30, max_iter 6, as tests/test_dist_scale_parity.py) makes every
side take the same number of steps.

Run as a program, this file is one rank's worker:
    python tests/test_torch_distributed.py <rank> <world> <port> <case> <out.npz>
"""

import sys

import numpy as np
import pytest

LS = {"ftol": 1e-30, "xtol": 1e-30, "max_iter": 6}
AFFINE_PARAMS = ["R", "T", "K", "COMMON_K"]


def port_problem(case):
    """The port's BAParams of a case, and the numpy inputs it was built from."""
    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.utils import demo

    if case == "rpc":
        scene = demo.make_scene_arrays(n_cam=12, n_pts=600, rot_scale=2e-5, noise_px=0.1, seed=0,
                                       device="cpu")
        return demo.scene_to_baparams(scene), scene
    s = demo.make_matrix_scene("affine", n_cam=12, n_pts=300, obs_per_pt=4, noise_px=0.05,
                               seed=0)
    d = {"verbose": False, "correction_params": AFFINE_PARAMS}
    p = BAParams.from_obs_table(s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"],
                                s["cameras_init"], "affine", s["camera_centers"], s["pairs"], d)
    return p, s


def jax_problem(case, inputs):
    """The JAX package's BAParams of the same inputs."""
    from sat_bundleadjust_tpu.ba.params import BAParams
    from sat_bundleadjust_tpu.models.rpc import RPCModel

    if case == "rpc":
        n_cam = inputs["cam_params0"].shape[0]
        pts0 = inputs["pts3d"] + 1.0 * np.random.RandomState(1).randn(len(inputs["pts3d"]), 3)
        rpcs = [RPCModel(**{f: np.asarray(getattr(r, f)) for f in RPCModel._fields})
                for r in inputs["rpc_list"]]
        pairs = [(i, j) for i in range(n_cam) for j in range(i + 1, n_cam)]
        return BAParams.from_obs_table(inputs["pts_ind"], inputs["cam_ind"], inputs["pts2d"], pts0,
                                       rpcs, "rpc", list(inputs["camera_centers"]), pairs,
                                       {"verbose": False})
    s = inputs
    d = {"verbose": False, "correction_params": AFFINE_PARAMS}
    return BAParams.from_obs_table(s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"],
                                   s["cameras_init"], "affine", s["camera_centers"], s["pairs"], d)


def _worker(rank, world, port, case, out):
    import torch
    import torch.distributed as dist

    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.parallel.dist_solver import run_distributed_ba
    from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.initialize("127.0.0.1:" + port, int(world), int(rank), backend="gloo")
    p, _ = port_problem(case)
    _, (cam, pts), info = run_distributed_ba(p, dict(LS), mesh=make_mesh(device="cpu"))
    np.savez(out, cam=cam.numpy(), pts=pts.numpy(), err0=info["err0"], err_fin=info["err_fin"],
             scalars=np.array([info["cost0"], info["cost"], info["lambda"]]),
             counts=np.array([info["iterations"], info["cg_iterations"], info["matvecs"],
                              info["allreduces"], info["host_syncs"], info["n_shards"]]))
    dist.destroy_process_group()


# per camera parameter: the largest difference over the largest step from
# the start (measured: rpc 1.4e-3, affine 1.2e-2, where gauge-like
# directions of the affine problem are weakly determined)
CAM_TOL = {"rpc": 5e-3, "affine": 3e-2}
# per observation: the final reprojection errors (px; measured: rpc 8.3e-5,
# affine 4.0e-6)
ERR_TOL = 5e-4


@pytest.mark.parametrize("case", ["rpc", "affine"])
def test_two_rank_solve_matches_jax_and_one_device(case, tmp_path):
    """Both ranks return the same bits (cam, pts, errors, costs and
    counters). Against JAX's 2-shard solve, which sums the same 2 partials,
    and against the port's one-device CG solve: the same iterations, the
    final mean reprojection error within 1e-3 px (chip_smoke's bar), every
    observation's within ERR_TOL, the cameras within CAM_TOL. The CPU CG
    operators differ on purpose (the port's "auto" is schur_wz_plain, f64
    camera sums; JAX's is "aos", f32), and the f32 normal equations sum in
    another order on each side (see tests/test_torch_solver.py), which the
    CG carries through six LM steps."""
    from test_torch_ranks import run_ranks

    from sat_bundleadjust_tpu.parallel.dist_solver import run_distributed_ba as jrun
    from sat_bundleadjust_tpu.parallel.mesh import make_mesh as jmake_mesh

    from sat_bundleadjust_tpu_torch.ba.solver import BASolver, run_ba_optimization

    logs = run_ranks(__file__, [case, str(tmp_path / "rank")], 2, timeout=240)
    res = [dict(np.load(str(tmp_path / "rank{}.npz".format(r)))) for r in range(2)]
    for k in res[0]:
        assert np.array_equal(res[0][k], res[1][k]), (k, logs[1][-2000:])
    r = res[0]
    iters, cg_its, matvecs, allreduces, _, n_shards = r["counts"]
    assert iters == LS["max_iter"] and n_shards == 2
    # one all-reduce per operator application; per LM step g_cam, b,
    # S_diag, E, the finite flag, the point rejoin and the new cost; and
    # the first cost
    assert matvecs >= cg_its > 0
    assert allreduces == matvecs + 7 * iters + 1

    p, inputs = port_problem(case)
    _, (jcam, _), jinfo = jrun(jax_problem(case, inputs), dict(LS), mesh=jmake_mesh(n_devices=2))
    _, (tcam, _), _, terr, tit = run_ba_optimization(
        p, dict(LS), solver=BASolver(p, schur_mode="cg", device="cpu"))
    assert jinfo["iterations"] == tit == iters
    assert r["err_fin"].shape == r["err0"].shape == (p.n_obs,)
    assert r["err_fin"].mean() < 0.2 * r["err0"].mean()
    cam0 = p.opt_block()
    for other_cam, other_err in ((np.asarray(jcam), jinfo["err_fin"]), (tcam.numpy(), terr)):
        assert abs(float(r["err_fin"].mean()) - float(np.mean(other_err))) <= 1e-3
        assert np.abs(r["err_fin"] - other_err).max() <= ERR_TOL
        step = np.abs(other_cam - cam0).max(axis=0)
        assert np.all(np.abs(r["cam"] - other_cam).max(axis=0) <= CAM_TOL[case] * step)


if __name__ == "__main__":
    rank, world, port, case, prefix = sys.argv[1:]
    _worker(rank, world, port, case, "{}{}.npz".format(prefix, rank))


def test_main_distributed_on_one_rank(tmp_path):
    """main(cfg) with "distributed": true in one process (no process group:
    a mesh of one rank): every BA round goes through the distributed
    solver, whose sums over one shard are the shard's own, and the run
    meets tests/test_e2e.py's thresholds."""
    import glob
    import os

    import sat_bundleadjust_tpu_torch
    from sat_bundleadjust_tpu_torch.parallel.mesh import get_default_mesh, set_default_mesh
    from test_torch_multihost import write_config, write_scene

    cfg, out = write_config(str(tmp_path), "one", write_scene(str(tmp_path)))
    try:
        scene = sat_bundleadjust_tpu_torch.main(cfg, device="cpu")
        mesh = get_default_mesh()
    finally:
        set_default_mesh(None)
    pipe = scene.ba_pipeline
    assert mesh is pipe.mesh and mesh.size == 1 and mesh.device.type == "cpu"
    assert len(pipe.ba_rounds) == 2
    assert all(r["allreduces"] == 0 and r["matvecs"] > 0 for r in pipe.ba_rounds)
    assert len(glob.glob(os.path.join(out, "rpcs_adj", "*.rpc_adj"))) == 4
    init_e, ba_e = float(np.mean(pipe.init_e)), float(np.mean(pipe.ba_e))
    assert init_e > 1.0 and ba_e < 0.5 * init_e, (init_e, ba_e)
