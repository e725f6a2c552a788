"""Parity of the port's robot zoo (qppvm_tpu_torch/model/zoo.py) with
qppvm_tpu's: every model ``by_name`` builds beside the humanoid (whose
parity tests/test_torch_model.py holds), and the centaur's kinematics and
dynamics at random states.

The same numpy-seeded states go through the JAX reference (float32
pinned, although the suite enables x64; one jitted, vmapped program) and
through the port in float32 with a leading batch dimension.

Tolerances: rtol 1e-5. The model arrays come from the same builder
arithmetic in float64, rounded once to float32, so they agree to the
rounding (absolute floor 1e-6). ``fk``, ``rnea`` and ``mass_matrix`` run
float32 with sums in another order through the centaur's tree (legs four
deep, arms eight deep): absolute floor 1e-5 of each quantity's scale, tens
of float32 ulps; a wrong axis, offset, mass or parent moves them by O(1)
of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import dynamics as jdyn
from qppvm_tpu.model import kinematics as jkin
from qppvm_tpu.model import robot as jrobot
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu_torch.model import convert, dynamics, kinematics, zoo

torch.set_num_threads(1)
B = 3
# (nj, nv) of each model, as the reference's tests/test_centaur.py counts
SIZES = {"arm7": (7, 7), "dual_arm": (15, 15), "quadruped": (16, 22),
         "biped": (12, 18), "centaur": (31, 37)}


def _close(actual, desired, floor=1e-5):
    desired = np.asarray(desired, np.float64)
    scale = float(np.max(np.abs(desired))) + 1.0
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired,
                               rtol=1e-5, atol=floor * scale)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_zoo_model_matches_reference(name):
    jm, tm = jzoo.by_name(name), zoo.by_name(name, device="cpu")
    for k in convert.MODEL_ARRAYS:
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in convert.MODEL_META:
        assert getattr(tm, k) == getattr(jm, k), k
    assert (tm.nj, tm.nv) == (jm.nj, jm.nv) == SIZES[name]
    assert tm.dtype == torch.float32 and tm.device.type == "cpu"


def test_by_name_builds_every_model_on_the_device_asked():
    for name in list(SIZES) + ["humanoid"]:
        m = zoo.by_name(name, dtype=torch.float64, device="cpu")
        assert m.dtype == torch.float64 and m.device.type == "cpu"
    with pytest.raises(KeyError):
        zoo.by_name("hexapod", device="cpu")


@pytest.fixture(scope="module")
def centaur_case():
    jm, tm = jzoo.centaur(), zoo.centaur(device="cpu")
    rng = np.random.default_rng(0)
    rots = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                     for _ in range(B)])
    rots[:, :, 0] *= np.linalg.det(rots)[:, None]     # proper rotations
    arrs = dict(q=0.5 * rng.normal(size=(B, tm.nj)),
                qd=rng.normal(size=(B, tm.nj)), base_rot=rots,
                base_pos=0.3 * rng.normal(size=(B, 3)),
                base_vel=rng.normal(size=(B, 6)))
    udot = rng.normal(size=(B, tm.nv))

    def one(st, ud):
        return dict(fk=jkin.fk(jm, st), rnea=jdyn.rnea(jm, st, ud),
                    B=jdyn.mass_matrix(jm, st))

    jst = jrobot.RobotState(**{k: jnp.asarray(v, jnp.float32)
                               for k, v in arrs.items()})
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(
        jst, jnp.asarray(udot, jnp.float32)))
    return tm, convert.robot_state(arrs, device="cpu"), udot, ref


def test_centaur_fk_matches_reference(centaur_case):
    tm, ts, _, ref = centaur_case
    kin = kinematics.fk(tm, ts)
    for k in ("R", "p", "S_ang"):
        _close(getattr(kin, k), getattr(ref["fk"], k))


def test_centaur_rnea_matches_reference(centaur_case):
    tm, ts, udot, ref = centaur_case
    _close(dynamics.rnea(tm, ts, torch.tensor(udot, dtype=torch.float32)),
           ref["rnea"])


def test_centaur_mass_matrix_matches_reference(centaur_case):
    tm, ts, _, ref = centaur_case
    _close(dynamics.mass_matrix(tm, ts), ref["B"])
