"""The batched SFM projection (vmap of models.sfm.project_people, the
production path) against per-lane scans, with the windowed ESDF lookup on."""

import jax
import jax.numpy as jnp
import numpy as np

from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu.models.sfm import DEFAULT_PARAMS, project_people
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario


def _batch_inputs(b, n_people, seed0=0):
    cfg = benchmark_social_config()
    from nav2_social_mpc_controller_tpu.controller.optimize import ProblemDims
    from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize
    from nav2_social_mpc_controller_tpu.controller.optimize import format_to_optimize
    from nav2_social_mpc_controller_tpu.core.types import ControllerCarry

    dims = ProblemDims.from_config(cfg)
    rows_b, n_rows_b, sc_b = [], [], []
    for s in range(b):
        sc = make_scenario(cfg, seed=seed0 + s, n_valid_people=n_people)
        res = trajectorize(cfg.trajectorizer, sc.path, jnp.asarray(sc.robot.pose))
        carry = ControllerCarry(
            prev_path=jnp.zeros((dims.maxsize, 3), jnp.float32),
            prev_cmds=jnp.zeros((dims.maxsize, 2), jnp.float32),
            prev_n=jnp.zeros((), jnp.int32),
        )
        rows, n_rows = format_to_optimize(
            cfg, dims, res.poses, res.cmds, res.n_steps,
            jnp.asarray(sc.robot.speed), carry,
        )
        rows_b.append(rows)
        n_rows_b.append(n_rows)
        sc_b.append(sc)
    stackf = lambda xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs])
    return cfg, dims, sc_b, stackf(rows_b), jnp.stack(n_rows_b)


def _kw(cfg):
    return dict(
        maxtime=cfg.trajectorizer.max_time,
        dt=cfg.trajectorizer.time_step,
        params=DEFAULT_PARAMS,
        people_desired_vel=cfg.people_desired_vel,
        people_radius=cfg.people_radius,
        robot_desired_vel=cfg.robot_sfm_desired_vel,
        robot_radius=cfg.robot_sfm_radius,
        goal_radius=cfg.goal_radius,
        esdf_window=cfg.esdf_window_cells,
    )


def _esdf_batch(scs):
    return (
        jnp.stack([jnp.asarray(sc.esdf.distances, jnp.float32) for sc in scs]),
        jnp.stack([jnp.asarray(sc.esdf.indexes) for sc in scs]),
        jnp.stack([jnp.asarray(sc.esdf.origin, jnp.float32) for sc in scs]),
        jnp.stack([jnp.asarray(sc.esdf.resolution, jnp.float32) for sc in scs]),
    )


def test_batched_projection_matches_per_lane_scan():
    b, n_people = 5, 3
    cfg, dims, scs, rows_b, n_rows_b = _batch_inputs(b, n_people)
    kw = _kw(cfg)
    init_b = jnp.stack([jnp.asarray(sc.people.state, jnp.float32) for sc in scs])
    valid_b = jnp.stack([jnp.asarray(sc.esdf.valid) for sc in scs])
    esdf = _esdf_batch(scs)
    got = jax.jit(jax.vmap(lambda *a: project_people(*a, **kw)))(
        init_b, rows_b, n_rows_b, *esdf, valid_b
    )
    ref = jnp.stack([
        project_people(init_b[i], rows_b[i], n_rows_b[i],
                       *(x[i] for x in esdf), valid_b[i], **kw)
        for i in range(b)
    ])
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.asarray(got[..., 3]), np.asarray(ref[..., 3]))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_batched_projection_invalid_esdf_freezes_agents():
    b, n_people = 2, 2
    cfg, dims, scs, rows_b, n_rows_b = _batch_inputs(b, n_people, seed0=7)
    init_b = jnp.stack([jnp.asarray(sc.people.state, jnp.float32) for sc in scs])
    got = jax.vmap(lambda *a: project_people(*a, **_kw(cfg)))(
        init_b, rows_b, n_rows_b, *_esdf_batch(scs),
        jnp.zeros((b,), bool),  # invalid ESDF everywhere
    )
    # Invalid ESDF -> no agents projected: steps >= 1 all t = -1 (the
    # reference's continue-before-push_back quirk).
    assert np.all(np.asarray(got[:, 1:, :, 3]) == -1.0)
    np.testing.assert_array_equal(np.asarray(got[:, 0]), np.asarray(init_b))
