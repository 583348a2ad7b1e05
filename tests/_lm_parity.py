"""Helpers shared by the parity tests of the port's model stack
(tests/test_torch_ssm.py, test_torch_lm_kinds.py, test_torch_lm_embeds.py,
test_torch_serve_kinds.py, test_torch_train.py,
test_torch_train_kinds.py): the same config in both packages, numpy and
torch conversions, the tolerance check, one reference run of an LM, and
the training loss with its gradients against the reference's.

Tolerances, each of max|ref|:

* float32 compute: 1e-4 (float32 arithmetic in another order);
* bfloat16 compute: 2e-2 (every activation is rounded to 8 bits, as the
  reference's own serving test allows: tests/test_serving.py);
* decode caches stored in bfloat16 by both: 2^-8, one bfloat16 rounding
  step, which a float32 difference of one ulp before the cast can flip
  (the compute tolerance where that is larger: ``close_caches``);
* the training loss (float32): 1e-5 of |ref| (float32 sums in another
  order; measured at most 1e-7), each parameter's gradient 1e-4 of that
  gradient's max|ref| (measured at most 4e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as rconfigs
from repro.data import SyntheticDataset as RData
from repro.models import lm as rlm
from repro.models.config import ShapeConfig as RShape
from repro_torch import configs as pconfigs
from repro_torch.convert import flatten_reference, lm_from_reference
from repro_torch.models.lm import loss_fn, padded_vocab

F32_TOL, BF16_TOL, CACHE_TOL, LOSS_TOL = 1e-4, 2e-2, 2.0 ** -8, 1e-5


def cfgs(arch, **changes):
    """(the reference's smoke config, the port's), both with ``changes``."""
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **changes),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **changes))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def f32(a):
    """A numpy float32 copy of a tensor or (bfloat16) array."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(ours, theirs, rel, what=""):
    ours, theirs = f32(ours), f32(theirs)
    assert ours.shape == theirs.shape, (what, ours.shape, theirs.shape)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=rel * np.abs(theirs).max(), err_msg=what)


def close_caches(ours, want, rel, what=""):
    """Two of the port's decode caches: equal lengths; bfloat16 entries
    within max(2^-8, ``rel``) (in a bfloat16 computation the cached k and v
    of a layer past the first are activations that carry the rounding of
    the layers before it), float32 states within ``rel``."""
    assert torch.equal(ours["len"], want["len"])
    assert len(ours["layers"]) == len(want["layers"])
    for i, (a, b) in enumerate(zip(ours["layers"], want["layers"])):
        assert set(a) == set(b), (what, i, sorted(a), sorted(b))
        for k in a:
            assert a[k].dtype == b[k].dtype, (what, i, k)
            bf16 = a[k].dtype == torch.bfloat16
            close(a[k], f32(b[k]), max(CACHE_TOL, rel) if bf16 else rel,
                  f"{what} {i} {k}")


def tol(cfg):
    return F32_TOL if cfg.compute_dtype == "float32" else BF16_TOL


def vocab(cfg, a):
    """The first vocab_size columns; the pad columns must be -1e30."""
    a = f32(a)
    v = cfg.vocab_size
    assert a.shape[-1] == padded_vocab(cfg)
    if a.shape[-1] > v:
        np.testing.assert_allclose(a[..., v:], -1e30, rtol=1e-3)
    return a[..., :v]


def batch(inputs, lo, hi, backend):
    """The [lo, hi) slice of the sequence of ``inputs`` ({"tokens"} or
    {"embeds"}, with optional (B, S) or (3, B, S) "positions") as a batch
    of jnp arrays or of tensors."""
    out = {}
    for name, a in inputs.items():
        a = a[..., lo:hi] if name == "positions" else a[:, lo:hi]
        if backend == "jax":
            out[name] = jnp.asarray(a)
        else:
            out[name] = t(a).long() if name == "tokens" else t(a)
    return out


def reference_run(rc, pc, inputs, s, new):
    """The reference's forward over all of ``inputs``, its prefill of the
    first ``s`` positions (cache of s + new) and ``new`` decode steps fed
    the rest; and the port's LM on the same weights."""
    params = rlm.init_params(rc, jax.random.key(0))
    full, aux = jax.jit(lambda p, b: rlm.forward(p, rc, b))(
        params, batch(inputs, 0, s + new, "jax"))
    lg, cache = jax.jit(lambda p, b: rlm.prefill(p, rc, b, s + new))(
        params, batch(inputs, 0, s, "jax"))
    ref_cache = to_np(cache)
    step = jax.jit(lambda p, c, b: rlm.decode_step(p, rc, c, b))
    steps = []
    for i in range(new):
        one = {k: v for k, v in batch(inputs, s + i, s + i + 1, "jax").items()
               if k != "positions"}
        lg2, cache = step(params, cache, one)
        steps.append(np.asarray(lg2))
    return dict(rc=rc, pc=pc, inputs=inputs, s=s, new=new,
                params=to_np(params), forward=f32(full), aux=float(aux),
                prefill=np.asarray(lg), cache=ref_cache, steps=steps,
                model=lm_from_reference(to_np(params), pc, device="cpu"),
                tol=tol(rc))


def tensors(batch):
    """A numpy batch as tensors, token ids and labels as int64."""
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def loss_parity(arch, changes, positions=None):
    """loss_fn and every gradient against jax.value_and_grad of the
    reference's loss_fn, on one SyntheticDataset batch of the config."""
    rc, pc = cfgs(arch, compute_dtype="float32", **changes)
    b = RData(rc, RShape("t", 16, 2, "train"), seed=3).batch_at(0)
    if positions is not None:
        b["positions"] = positions
    params = rlm.init_params(rc, jax.random.key(0))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, x: rlm.loss_fn(p, rc, x), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in b.items()})
    model = lm_from_reference(to_np(params), pc, device="cpu")
    ours, our_metrics = loss_fn(model, tensors(b))
    ours.backward()
    for name, value in (("loss", loss), ("nll", metrics["nll"]),
                        ("aux", metrics["aux"])):
        got = ours if name == "loss" else our_metrics[name]
        assert abs(float(got.detach()) - float(value)) <= LOSS_TOL * abs(
            float(value)), (name, float(got.detach()), float(value))
    want = flatten_reference(to_np(grads), rc)
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(got, want[name], F32_TOL, name)
    return float(metrics["aux"])
