"""``remat_policy`` in the port (``models/common.remat``,
``blocks.stack_forward``): a selective checkpoint of each period, the
counterpart of the reference's ``jax.checkpoint(policy=...)``.

Reduced qwen3-4b under a one-device policy on CPU at float32: with
``dots_saveable`` and ``nothing_saveable`` the loss equals ``remat=False``
within 1e-5 relative and every gradient leaf within 1e-4 of its max
|entry| (``tests/test_torch_train.py``'s bars); ``dots_saveable`` keeps
the products (its backward recomputes none of them, ``nothing_saveable``
recomputes every one); a list of ops and a callable are taken as
``create_selective_checkpoint_contexts`` takes them. The loss against
the reference's under ``jax.checkpoint_policies`` is
``tests/test_torch_train.py::test_remat_policy_matches_reference_policy``."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.common import DOT_OPS, checkpoint_policy
from repro_torch.sharding.policy import make_policy
from repro_torch.tree_util import tree_leaves, tree_unflatten

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched under it."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in DOT_OPS
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def qwen():
    cfg = registry.get_reduced("qwen3-4b")
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, torch.float32)
    params = tree_unflatten(params, [p + 0.1 * torch.randn(p.shape,
                                                           generator=gen)
                                     for p in tree_leaves(params)])
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    policy = make_policy(make_host_mesh(device="cpu"), global_batch=2)
    return cfg, params, batch, policy


def _loss_grads(qwen, **kw):
    """(loss, gradients, products in the backward)."""
    cfg, params, batch, policy = qwen
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = lm.loss_fn(cfg, tree_unflatten(params, leaves), batch, policy,
                         loss_chunk=16, **kw)
    with _Products() as products:
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, products.count


@pytest.mark.parametrize("name", ["dots_saveable", "nothing_saveable"])
def test_remat_policy_matches_no_remat(qwen, name):
    l0, g0, _ = _loss_grads(qwen, remat=False)
    l1, g1, _ = _loss_grads(qwen, remat=True, remat_policy=name)
    assert abs(float(l1) - float(l0)) <= LOSS_TOL * abs(float(l0))
    for a, b in zip(g1, g0):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= GRAD_TOL * scale


def test_dots_saveable_keeps_the_products(qwen):
    """The backward's products: with dots_saveable as many as without
    remat (none recomputed), with nothing_saveable more (the periods'
    forward products again), as many as plain remat."""
    _, _, plain = _loss_grads(qwen, remat=False)
    _, _, dots = _loss_grads(qwen, remat=True, remat_policy="dots_saveable")
    _, _, nothing = _loss_grads(qwen, remat=True,
                                remat_policy="nothing_saveable")
    _, _, full = _loss_grads(qwen, remat=True)
    assert dots == plain
    assert nothing == full > plain


def test_remat_policy_forms(qwen):
    """A list of ops to save and a callable go to torch as they are; an
    unknown name or another object raises."""
    _, g0, _ = _loss_grads(qwen, remat=False)

    def save_mm(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
                else CheckpointPolicy.PREFER_RECOMPUTE)
    for form in ([torch.ops.aten.mm.default], save_mm):
        _, g1, _ = _loss_grads(qwen, remat=True, remat_policy=form)
        for a, b in zip(g1, g0):
            assert torch.allclose(a, b, rtol=0,
                                  atol=GRAD_TOL * float(b.abs().max()))
    with pytest.raises(ValueError, match="remat policy"):
        checkpoint_policy("everything_saveable")
    with pytest.raises(TypeError, match="remat policy"):
        checkpoint_policy(object())
