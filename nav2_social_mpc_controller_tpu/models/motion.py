"""Motion models: block-constant control rollout and the trajectorizer's
unicycle/omnidirectional integrators.

Reference parity targets:
  rollout_poses <- computeUpdatedStateRedux (update_state.hpp:38-63).
      The reference re-integrates the unicycle model from pose_0 up to step i
      inside EVERY residual evaluation — O(H^2) integrations per Jacobian
      pass across ~8 critics. Here the rollout is ONE lax.scan producing all
      H poses, shared by every critic; Jacobians flow through the single
      scan (jacfwd: B*2 tangents through O(H) work).
  integrate_step / omni terms <- PathTrajectorizer::computeNewXPosition /
      computeNewYPosition / computeNewThetaPosition
      (path_trajectorizer.hpp:106-135):
        x' = x + (vx cos(th) + vy cos(pi/2 + th)) dt
        y' = y + (vx sin(th) + vy sin(pi/2 + th)) dt
        th' = th + wz dt
  block_index_sequence <- the per-step parameter-block selection
      j < control_horizon ? j/block : (control_horizon-1)/block
      (update_state.hpp:48-59), precomputed statically.
"""

import jax
import jax.numpy as jnp
import numpy as np


def block_index_sequence(n_steps: int, control_horizon: int, block_length: int) -> np.ndarray:
    """Static map step -> decision-variable block index.

    Step j uses block j//block_length while j < control_horizon, and the last
    in-horizon block (control_horizon-1)//block_length beyond it
    (update_state.hpp:48-59). Shapes are static so this is a numpy constant
    baked into the jitted program.
    """
    j = np.arange(n_steps)
    return (np.minimum(j, control_horizon - 1) // block_length).astype(np.int32)


def block_index_sequence_dynamic(n_steps: int, control_horizon, block_length):
    """Dynamic-horizon variant: control_horizon/block_length are traced
    scalars (the reference shrinks them to the velocity count near the goal,
    optimizer.cpp:248-249). Returns a (n_steps,) int32 device array."""
    j = jnp.arange(n_steps)
    return (jnp.minimum(j, control_horizon - 1) // block_length).astype(jnp.int32)


def expand_blocks(u: jnp.ndarray, block_idx) -> jnp.ndarray:
    """Per-step controls u[block_idx] as a one-hot product: (S, B) x (B, 2).

    It sits inside every LM residual evaluation. Broadcast-multiply-reduce
    (NOT a matmul): a DEFAULT-precision matmul may round its f32 operands
    (TF32 on the GPU), which would QUANTIZE every expanded control — a
    published command could then exceed its bound (e.g. v = 0.6015625 >
    0.6). The where/sum form is an exact copy and fuses into elementwise
    ops."""
    onehot = jnp.asarray(block_idx)[:, None] == jnp.arange(u.shape[0])
    return jnp.sum(jnp.where(onehot[..., None], u[None, :, :], 0.0), axis=1)


def rollout_poses(pose0: jnp.ndarray, u: jnp.ndarray, dt: float, block_idx: np.ndarray):
    """Integrate the unicycle model under block-constant controls.

    pose0: (3,) [x, y, theta]; u: (B, 2) decision blocks [(v, w)];
    block_idx: static (S,) int array from block_index_sequence.

    Returns poses: (S+1, 3) — poses[0] == pose0, poses[k] is the state after
    k Euler steps, i.e. the `computeUpdatedStateRedux(..., i=k-1, ...)`
    result of the reference.
    """
    v_seq = expand_blocks(u, block_idx)  # (S, 2)

    # The unicycle recurrence is a PREFIX SUM, not a true recurrence: theta
    # is linear in the controls (theta_k = theta_0 + dt * sum w_j), and each
    # position step reads theta BEFORE its own update, so
    #   x_k = x_0 + dt * cumsum(v * cos(theta_{k-1}))   (same for y).
    # Three cumsums replace the sequential lax.scan the first formulation
    # used — which lowered to a while loop run TWICE per LM iteration
    # (primal + linearize tangent replay). cumsum
    # reassociates additions vs the sequential scan (~1e-7 relative in f32);
    # parity suites compare in f64 at >=1e-8 tolerances, unaffected.
    th0 = pose0[2]
    th = th0 + dt * jnp.cumsum(v_seq[:, 1])  # theta after step k
    th_prev = jnp.concatenate([th0[None], th[:-1]])  # theta read by step k
    x = pose0[0] + dt * jnp.cumsum(v_seq[:, 0] * jnp.cos(th_prev))
    y = pose0[1] + dt * jnp.cumsum(v_seq[:, 0] * jnp.sin(th_prev))
    traj = jnp.stack([x, y, th], axis=-1)
    return jnp.concatenate([pose0[None, :], traj], axis=0)


def integrate_step(x, y, theta, vx, vy, wz, dt):
    """One trajectorizer Euler step (path_trajectorizer.hpp:106-135).

    Note cos(pi/2+th) = -sin(th), sin(pi/2+th) = cos(th): vy acts along the
    body's left axis (omnidirectional strafing).
    """
    nx = x + (vx * jnp.cos(theta) - vy * jnp.sin(theta)) * dt
    ny = y + (vx * jnp.sin(theta) + vy * jnp.cos(theta)) * dt
    nth = theta + wz * dt
    return nx, ny, nth
