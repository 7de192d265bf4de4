"""Model-layer tests: ACT policy family, transformer, masked norm, rotations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloudmatters_tpu.models.components.act.act import ACTPCD, ACTRLBenchPCD
from pointcloudmatters_tpu.models.components.act.positional_encoding import (
    PositionEmbeddingLearned,
    PositionEmbeddingSine,
    coord_embedding_sine,
)
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer,
    TransformerEncoder,
)
from pointcloudmatters_tpu.models.components.loss.misc import KLDivergence
from pointcloudmatters_tpu.models.components.nn_utils import (
    MaskedBatchNorm,
    get_sinusoid_encoding_table,
)
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import PointNet
from pointcloudmatters_tpu.utils import rotation_conversions as rc

HIDDEN = 48
NQ = 6
ADIM = 8
QDIM = 9


def tiny_policy(cls=ACTPCD, **kw):
    return cls(
        backbone=PointNet(in_channels=6),
        transformer=Transformer(
            d_model=HIDDEN, nhead=4, num_encoder_layers=2, num_decoder_layers=3,
            dim_feedforward=32, return_intermediate_dec=True,
        ),
        encoder=TransformerEncoder(
            d_model=HIDDEN, nhead=4, dim_feedforward=32, num_layers=2
        ),
        hidden_dim=HIDDEN, num_queries=NQ, num_cameras=0,
        action_dim=ADIM, qpos_dim=QDIM, goal_cond_dim=3,
        pcd_nsample=4, pcd_npoints=16,
        **kw,
    )


def pcd_batch(B=2, N=64, seed=0, adim=ADIM):
    rng = np.random.RandomState(seed)
    counts = np.array([N - 10, N])[:B]
    valid = np.arange(N)[None] < counts[:, None]
    return {
        "qpos": jnp.asarray(rng.randn(B, QDIM), jnp.float32),
        "actions": jnp.asarray(rng.randn(B, NQ, adim), jnp.float32),
        "is_pad": jnp.asarray(np.arange(NQ)[None].repeat(B, 0) >= NQ - 1),
        "goal_cond": jnp.asarray(rng.randn(B, 3), jnp.float32),
        "pcds": {
            "coord": jnp.asarray(rng.randn(B, N, 3), jnp.float32),
            "feat": jnp.asarray(rng.randn(B, N, 6), jnp.float32),
            "valid": jnp.asarray(valid),
        },
    }


@pytest.fixture(scope="module")
def act_setup():
    policy = tiny_policy()
    data = pcd_batch()
    rng = jax.random.PRNGKey(0)
    variables = policy.init({"params": rng, "vae": rng, "dropout": rng}, data, train=True)
    return policy, data, variables


class TestACTPCD:
    def test_train_forward(self, act_setup):
        policy, data, variables = act_setup
        out, _ = policy.apply(
            variables, data, train=True,
            rngs={"vae": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
            mutable=["batch_stats"],
        )
        assert out["a_hat"].shape == (2, NQ, ADIM)
        assert out["is_pad_hat"].shape == (2, NQ, 1)
        for k in ("loss", "action_loss", "kl_loss"):
            assert np.isfinite(float(out[k])), k
        # loss = action + kl_weight * kl  (`act/act.py:289`)
        np.testing.assert_allclose(
            float(out["loss"]),
            float(out["action_loss"]) + policy.kl_weight * float(out["kl_loss"]),
            rtol=1e-5,
        )

    def test_eval_no_actions(self, act_setup):
        policy, data, variables = act_setup
        ev = {k: v for k, v in data.items() if k not in ("actions", "is_pad")}
        out = policy.apply(variables, ev, train=False)
        assert out["a_hat"].shape == (2, NQ, ADIM)
        assert "loss" not in out
        # deterministic at eval
        out2 = policy.apply(variables, ev, train=False)
        np.testing.assert_array_equal(np.asarray(out["a_hat"]), np.asarray(out2["a_hat"]))

    def test_decoder_layer0_quirk(self, act_setup):
        """Only decoder layer 0 contributes (`act/act.py:262-270` takes hs[0]);
        later layers must receive exactly zero gradient (and XLA DCEs them)."""
        policy, data, variables = act_setup
        rngs = {"vae": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}

        def loss_fn(params):
            out = policy.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                data, train=True, rngs=rngs, mutable=["batch_stats"],
            )[0]
            return out["loss"]

        grads = jax.grad(loss_fn)(variables["params"])
        dec = grads["transformer"]["decoder"]
        l0 = sum(float(jnp.sum(jnp.abs(g))) for g in jax.tree.leaves(dec["layers_0"]))
        l2 = sum(float(jnp.sum(jnp.abs(g))) for g in jax.tree.leaves(dec["layers_2"]))
        assert l0 > 0.0
        assert l2 == 0.0

    def test_padding_invariance(self, act_setup):
        """Garbage in padded cloud slots must not change the policy output."""
        policy, data, variables = act_setup
        ev = {k: v for k, v in data.items() if k not in ("actions", "is_pad")}
        out_ref = policy.apply(variables, ev, train=False)["a_hat"]

        pcds = dict(ev["pcds"])
        valid = np.asarray(pcds["valid"])
        coord = np.asarray(pcds["coord"]).copy()
        feat = np.asarray(pcds["feat"]).copy()
        coord[~valid] = 777.0
        feat[~valid] = -555.0
        ev2 = dict(ev, pcds=dict(pcds, coord=jnp.asarray(coord), feat=jnp.asarray(feat)))
        out_alt = policy.apply(variables, ev2, train=False)["a_hat"]
        np.testing.assert_allclose(
            np.asarray(out_ref), np.asarray(out_alt), atol=1e-5
        )

    def test_jit_train_step_descends(self, act_setup):
        import optax

        policy, data, variables = act_setup
        tx = optax.adam(1e-3)
        opt_state = tx.init(variables["params"])

        @jax.jit
        def step(params, batch_stats, opt_state, key):
            def loss_fn(p):
                out, mut = policy.apply(
                    {"params": p, "batch_stats": batch_stats}, data, train=True,
                    rngs={"vae": key, "dropout": key}, mutable=["batch_stats"],
                )
                return out["loss"], mut["batch_stats"]

            (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), bs, opt_state, loss

        params, bs = variables["params"], variables["batch_stats"]
        losses = []
        for i in range(8):
            params, bs, opt_state, loss = step(
                params, bs, opt_state, jax.random.PRNGKey(i)
            )
            losses.append(float(loss))
        assert losses[-1] < losses[0], losses


class TestRLBenchHead:
    def test_eval_emits_quaternion(self):
        # action layout: pos(3) + rot6d(6) + gripper(1) = 10 channels in train
        policy = tiny_policy(cls=ACTRLBenchPCD)
        adim = 10
        policy = policy.clone(action_dim=adim)
        data = pcd_batch(adim=adim)
        rng = jax.random.PRNGKey(0)
        variables = policy.init(
            {"params": rng, "vae": rng, "dropout": rng}, data, train=True
        )
        out, _ = policy.apply(
            variables, data, train=True,
            rngs={"vae": rng, "dropout": rng}, mutable=["batch_stats"],
        )
        assert out["a_hat"].shape == (2, NQ, adim)
        # gripper channel is a sigmoid output
        assert np.all(np.asarray(out["a_hat"][..., -1]) >= 0)
        assert np.all(np.asarray(out["a_hat"][..., -1]) <= 1)

        ev = {k: v for k, v in data.items() if k not in ("actions", "is_pad")}
        out_ev = policy.apply(variables, ev, train=False)
        # eval: 6d rot -> quaternion, so 3 + 4 + 1 = 8 channels
        assert out_ev["a_hat"].shape == (2, NQ, 8)
        quat = np.asarray(out_ev["a_hat"][..., 3:7])
        np.testing.assert_allclose(np.linalg.norm(quat, axis=-1), 1.0, atol=1e-4)

    def test_position_loss_weight(self):
        policy = tiny_policy(cls=ACTRLBenchPCD).clone(
            action_dim=10, position_loss_weight=100.0, kl_weight=0.0
        )
        base = tiny_policy(cls=ACTRLBenchPCD).clone(
            action_dim=10, position_loss_weight=1.0, kl_weight=0.0
        )
        data = pcd_batch(adim=10)
        rng = jax.random.PRNGKey(0)
        variables = policy.init(
            {"params": rng, "vae": rng, "dropout": rng}, data, train=True
        )
        kw = dict(rngs={"vae": rng, "dropout": rng}, mutable=["batch_stats"])
        loss_w = policy.apply(variables, data, train=True, **kw)[0]["action_loss"]
        loss_b = base.apply(variables, data, train=True, **kw)[0]["action_loss"]
        assert float(loss_w) > float(loss_b)


class TestMaskedBatchNorm:
    def test_masked_stats_match_manual(self):
        rng = np.random.RandomState(0)
        x = rng.randn(4, 10, 8).astype(np.float32)
        mask = rng.rand(4, 10) > 0.4
        bn = MaskedBatchNorm()
        variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        y, mut = bn.apply(
            variables, jnp.asarray(x), mask=jnp.asarray(mask),
            use_running_average=False, mutable=["batch_stats"],
        )
        sel = x[mask]  # (n_valid, 8)
        mean, var = sel.mean(0), sel.var(0)
        expected = (x - mean) / np.sqrt(var + 1e-5)
        np.testing.assert_allclose(np.asarray(y), expected, atol=1e-4)
        # running stats: torch stores the *unbiased* variance
        n = sel.shape[0]
        np.testing.assert_allclose(
            np.asarray(mut["batch_stats"]["var"]),
            0.9 * 1.0 + 0.1 * var * n / (n - 1),
            rtol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(mut["batch_stats"]["mean"]), 0.1 * mean, atol=1e-5
        )

    def test_sync_across_mesh(self):
        """axis_name psum makes per-device stats equal the global stats."""
        x = np.random.RandomState(1).randn(8, 16, 4).astype(np.float32)
        bn_sync = MaskedBatchNorm(axis_name="data")
        variables = bn_sync.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))

        def fwd(xs):
            y, _ = bn_sync.apply(
                variables, xs, use_running_average=False, mutable=["batch_stats"]
            )
            return y

        y_sharded = jax.pmap(fwd, axis_name="data")(jnp.asarray(x))
        # unsynced single-device over the full batch should match
        bn_plain = MaskedBatchNorm()
        y_full, _ = bn_plain.apply(
            variables, jnp.asarray(x.reshape(-1, 16, 4)[:, :, :]),
            use_running_average=False, mutable=["batch_stats"],
        )
        np.testing.assert_allclose(
            np.asarray(y_sharded).reshape(-1, 4),
            np.asarray(y_full).reshape(-1, 4),
            atol=1e-4,
        )


class TestPointNet:
    def test_shapes_and_padding_invariance(self):
        net = PointNet(in_channels=6)
        rng = np.random.RandomState(0)
        feat = rng.randn(2, 32, 6).astype(np.float32)
        valid = np.arange(32)[None].repeat(2, 0) < np.array([[20], [32]])
        d = {"feat": jnp.asarray(feat), "valid": jnp.asarray(valid)}
        variables = net.init(jax.random.PRNGKey(0), d, train=True)
        out, _ = net.apply(variables, d, train=True, mutable=["batch_stats"])
        assert out.shape == (2, 32, 512)

        feat2 = feat.copy()
        feat2[~valid] = 99.0
        out2, _ = net.apply(
            variables, {"feat": jnp.asarray(feat2), "valid": jnp.asarray(valid)},
            train=True, mutable=["batch_stats"],
        )
        np.testing.assert_allclose(
            np.asarray(out)[valid], np.asarray(out2)[valid], atol=1e-4
        )


class TestTransformer:
    def test_key_padding_mask(self):
        """Padded memory tokens must not influence the decoder output."""
        tr = Transformer(d_model=32, nhead=4, num_encoder_layers=1,
                         num_decoder_layers=1, dim_feedforward=16)
        rng = np.random.RandomState(0)
        src = rng.randn(2, 10, 32).astype(np.float32)
        pos = rng.randn(1, 10, 32).astype(np.float32)
        query = jnp.asarray(rng.randn(4, 32), jnp.float32)
        latent = jnp.asarray(rng.randn(2, 32), jnp.float32)
        proprio = jnp.asarray(rng.randn(2, 1, 32), jnp.float32)
        add_pos = jnp.asarray(rng.randn(2, 32), jnp.float32)
        pad = np.zeros((2, 10), bool)
        pad[:, 7:] = True

        variables = tr.init(
            jax.random.PRNGKey(0), jnp.asarray(src), query, pos=jnp.asarray(pos),
            latent_input=latent, proprio_input=proprio,
            additional_pos_embed=add_pos, key_padding_mask=jnp.asarray(pad),
        )
        kw = dict(pos=jnp.asarray(pos), latent_input=latent,
                  proprio_input=proprio, additional_pos_embed=add_pos,
                  key_padding_mask=jnp.asarray(pad))
        out1 = tr.apply(variables, jnp.asarray(src), query, **kw)
        src2 = src.copy()
        src2[:, 7:] = 1234.5
        out2 = tr.apply(variables, jnp.asarray(src2), query, **kw)
        np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-4)

    def test_intermediate_stack_shape(self):
        """decoder_live_layers=1 (default) computes only hs[0] at apply time
        but keeps the full parameter tree; =None computes the whole stack,
        and the two agree on hs[0]."""
        rng = np.random.RandomState(0)
        src = jnp.asarray(rng.randn(2, 5, 32), jnp.float32)
        query = jnp.asarray(rng.randn(4, 32), jnp.float32)
        latent = jnp.asarray(rng.randn(2, 32), jnp.float32)
        proprio = jnp.asarray(rng.randn(2, 1, 32), jnp.float32)
        add_pos = jnp.asarray(rng.randn(2, 32), jnp.float32)
        pos = jnp.asarray(rng.randn(1, 5, 32), jnp.float32)
        kw = dict(d_model=32, nhead=4, num_encoder_layers=1,
                  num_decoder_layers=3, dim_feedforward=16,
                  return_intermediate_dec=True)
        tr_live = Transformer(**kw)  # decoder_live_layers defaults to 1
        tr_full = Transformer(**kw, decoder_live_layers=None)
        variables = tr_live.init(jax.random.PRNGKey(0), src, query, pos=pos,
                                 latent_input=latent, proprio_input=proprio,
                                 additional_pos_embed=add_pos)
        # init created the full tree: all 3 decoder layers have params
        assert {f"layers_{i}" for i in range(3)} <= set(
            variables["params"]["decoder"].keys()
        )
        hs_live = tr_live.apply(variables, src, query, pos=pos,
                                latent_input=latent, proprio_input=proprio,
                                additional_pos_embed=add_pos)
        hs_full = tr_full.apply(variables, src, query, pos=pos,
                                latent_input=latent, proprio_input=proprio,
                                additional_pos_embed=add_pos)
        assert hs_live.shape == (1, 2, 4, 32)
        assert hs_full.shape == (3, 2, 4, 32)
        np.testing.assert_allclose(np.asarray(hs_live[0]),
                                   np.asarray(hs_full[0]), rtol=1e-5,
                                   atol=1e-5)


class TestPositionalEncoding:
    def test_sine_2d_shape_and_range(self):
        pe = PositionEmbeddingSine(num_pos_feats=16, normalize=True)
        fmap = jnp.zeros((2, 7, 5, 64))
        pos = pe(fmap)
        assert pos.shape == (1, 35, 32)
        assert np.all(np.abs(np.asarray(pos)) <= 1.0 + 1e-6)

    def test_learned_2d(self):
        pe = PositionEmbeddingLearned(num_pos_feats=8)
        fmap = jnp.zeros((2, 4, 6, 64))
        variables = pe.init(jax.random.PRNGKey(0), fmap)
        pos = pe.apply(variables, fmap)
        assert pos.shape == (1, 24, 16)

    def test_coord_sine_3d(self):
        coord = jnp.asarray(np.random.RandomState(0).randn(2, 10, 3), jnp.float32)
        pos = coord_embedding_sine(coord, 512)
        assert pos.shape == (2, 10, 512)
        # tail padding is zero (512 - 3*170 = 2 channels)
        np.testing.assert_array_equal(np.asarray(pos[..., -2:]), 0.0)

    def test_sinusoid_table_parity(self):
        """Interleaved sin/cos layout of `act/utils.py:41-55`."""
        table = np.asarray(get_sinusoid_encoding_table(5, 8))[0]
        pos, j = 3, 4
        angle = pos / np.power(10000, 2 * (j // 2) / 8)
        np.testing.assert_allclose(table[pos, j], np.sin(angle), rtol=1e-5)
        np.testing.assert_allclose(
            table[pos, j + 1],
            np.cos(pos / np.power(10000, 2 * ((j + 1) // 2) / 8)), rtol=1e-5,
        )


class TestKL:
    def test_kl_formula(self):
        mu = jnp.asarray([[0.5, -0.5], [1.0, 0.0]])
        logvar = jnp.asarray([[0.0, 0.0], [0.2, -0.2]])
        got = float(KLDivergence()(mu, logvar))
        klds = -0.5 * (1 + np.asarray(logvar) - np.asarray(mu) ** 2 - np.exp(logvar))
        np.testing.assert_allclose(got, klds.sum(1).mean(0), rtol=1e-6)

    def test_none_mu(self):
        assert float(KLDivergence()(None, None)) == 0.0


class TestRotations:
    def test_6d_roundtrip(self):
        key = jax.random.PRNGKey(0)
        mats = rc.random_rotations(20, key)
        d6 = rc.matrix_to_rotation_6d(mats)
        back = rc.rotation_6d_to_matrix(d6)
        np.testing.assert_allclose(np.asarray(back), np.asarray(mats), atol=1e-5)

    def test_quaternion_roundtrip(self):
        key = jax.random.PRNGKey(1)
        quats = rc.standardize_quaternion(rc.random_quaternions(20, key))
        mats = rc.quaternion_to_matrix(quats)
        back = rc.matrix_to_quaternion(mats)
        np.testing.assert_allclose(np.asarray(back), np.asarray(quats), atol=1e-5)
        # valid rotation matrices
        eye = np.einsum("nij,nkj->nik", np.asarray(mats), np.asarray(mats))
        np.testing.assert_allclose(eye, np.eye(3)[None].repeat(20, 0), atol=1e-5)

    def test_axis_angle_roundtrip(self):
        aa = np.random.RandomState(0).randn(10, 3).astype(np.float32) * 0.5
        q = rc.axis_angle_to_quaternion(jnp.asarray(aa))
        back = rc.quaternion_to_axis_angle(q)
        np.testing.assert_allclose(np.asarray(back), aa, atol=1e-4)

    def test_euler_roundtrip(self):
        angles = np.random.RandomState(0).uniform(-1.0, 1.0, (10, 3)).astype(np.float32)
        m = rc.euler_angles_to_matrix(jnp.asarray(angles), "XYZ")
        back = rc.matrix_to_euler_angles(m, "XYZ")
        np.testing.assert_allclose(np.asarray(back), angles, atol=1e-4)

    def test_quaternion_apply_matches_matrix(self):
        key = jax.random.PRNGKey(2)
        q = rc.random_quaternions(5, key)
        pts = jnp.asarray(np.random.RandomState(0).randn(5, 3), jnp.float32)
        via_q = rc.quaternion_apply(q, pts)
        via_m = jnp.einsum("nij,nj->ni", rc.quaternion_to_matrix(q), pts)
        np.testing.assert_allclose(np.asarray(via_q), np.asarray(via_m), atol=1e-4)
