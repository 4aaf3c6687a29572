"""Layer primitives of the model zoo (`byzantinemomentum_tpu/models/core.py`,
the subset `empire-cnn`, the `simples-*` models and `wide_resnet` need).

Parameters keep the JAX package's layouts — HWIO convolution kernels and
(din, dout) dense weights — so the flat parameter vector of the port and
of the JAX package compare coordinate for coordinate. Activations are
PyTorch's NCHW; `conv_apply` views the HWIO kernel as OIHW.

Initialization is the JAX package's (`dense_init`, `conv_init`): torch's
default bounds for Linear/Conv2d, U(+-1/sqrt(fan_in)) for weights and
biases, drawn with `prng.uniform` in float32 from the two keys of
`prng.split(key)` in the JAX shapes, then rounded to the parameter dtype;
the same key gives the JAX package's bits. Dropout keep-masks come from
the JAX keys too (`worker_dropout_masks`).

Padding: a strided "same" convolution pads as XLA's SAME does, the
total `(out - 1) * stride + k - size` split `total // 2` before and the
rest after (`same_pads`): on 32 pixels a 3x3 stride-2 window pads 0
before and 1 after, where torch's symmetric `padding=1` would shift
every window by a pixel with the right output shape.

BatchNorm has torch's train-mode semantics: batch statistics in train
mode, running statistics in eval mode, and the running update
r <- (1-m) r + m s with momentum 0.1, eps 1e-5 and the unbiased batch
variance. Functions return the new running state instead of writing it,
so the honest phase can batch them over workers (`engine/step.py` folds
the per-worker states sequentially).

Dtypes, as in the JAX package: layers are built in the parameter dtype
(`dtype=`); BatchNorm accumulates its statistics at
`promote_types(x.dtype, float32)` and casts its output back to `x.dtype`
and its running state back to the state's dtype; dropout and pooling
stay in `x.dtype`; dropout divides by the keep rate rounded to
`x.dtype`, as JAX applies the weak Python scalar (bf16(0.7) =
0.69921875).

Worker-grouped layers (`grouped_*`, the JAX package's `grouped_*_apply`):
the honest phase can run all S per-worker networks as one merged program
(`EmpireCNN.forward_grouped`). Activations are worker-major batches,
`(S*B, C, H, W)`, so BatchNorm takes per-(s, c) statistics over a
`(S, B, C, H, W)` view (each worker's own, as in its own forward) and
returns `(S, C)` running-stat leaves, and dropout takes the vmapped
path's `(S, B, ...)` keep-masks as they are. A convolution and a dense
layer compute what `torch.func.vmap` makes of the per-worker layer, with
the same library calls: where every worker holds the same parameters
(`shared`: theta broadcast, the honest phase without a per-worker
lookahead) the forward and the input gradient are one convolution or
matmul over all S*B inputs with worker 0's copy; otherwise the forward is
one `groups=S` convolution on the worker-grouped layout `(B, S*C, H, W)`
(a `bmm` for a dense layer). The weight gradients are always per worker:
one `groups=S` convolution gradient, one `bmm`. (On an H100 in f32,
grouped convolutions for the forward and the input gradient cost a third
more than the vmapped program's, `PERF.md` §6.) The JAX package's worker
and batch-slot packing (`BMT_WORKER_PAD`, `BMT_NO_WORKER_PACK`,
`BMT_BATCH_PACK`) is not ported: it arranges channels for the TPU's
128-wide lanes, which this card does not have.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.ops import prng_kernels
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["BN_MOMENTUM", "BN_EPS", "Conv", "Dense", "BatchNorm",
           "batchnorm_train", "batchnorm_eval", "fold_running_stats",
           "same_pads", "grouped_conv", "grouped_dense", "grouped_batchnorm",
           "worker_dropout_masks", "dropout_apply",
           "max_pool", "global_avg_pool", "log_softmax", "inits",
           "apply_named_init"]

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


@torch.no_grad()
def _init_uniform(layer, key, fan_in):
    """`w`, `b` of a layer ~ U(+-1/sqrt(fan_in)) from `prng.split(key)`,
    drawn in float32 and rounded to the parameter dtype."""
    bound = 1.0 / math.sqrt(fan_in)
    for leaf, leaf_key in zip((layer.w, layer.b),
                              prng.split(key.to(layer.w.device))):
        leaf.copy_(prng.uniform(leaf_key, leaf.shape, torch.float32, -bound,
                                bound))


def same_pads(size, k, stride):
    """XLA's SAME padding of one spatial axis: `(before, after)` for an
    input of `size`, a window of `k` and `stride` (output
    `ceil(size / stride)`)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x, k, padding, stride):
    """`(top, bottom, left, right)` pads of an NCHW `x` for a k x k window
    ("same" as XLA's SAME, "valid" none)."""
    if padding == "valid":
        return (0, 0, 0, 0)
    return same_pads(x.shape[-2], k, stride) + same_pads(x.shape[-1], k, stride)


def _conv2d(x, w, b, pads, stride, groups=1):
    """`F.conv2d` with the `(top, bottom, left, right)` pads: symmetric
    ones as its `padding`, others by `F.pad` first."""
    top, bottom, left, right = pads
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride=stride, padding=(top, left),
                        groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride,
                    groups=groups)


class Conv(nn.Module):
    """A k x k convolution with an HWIO kernel `w` and bias `b`; `padding`
    is "same" (3x3 in `empire-cnn` and `wide_resnet`, XLA's SAME at a
    stride) or "valid" (the 5x5 convolutions of `simples-conv`, the 1x1
    shortcuts of `wide_resnet`)."""

    def __init__(self, cin, cout, k=3, padding="same", stride=1, device=None,
                 dtype=None):
        super().__init__()
        self.padding = padding
        self.stride = stride
        self.w = nn.Parameter(torch.empty((k, k, cin, cout), device=device,
                                          dtype=dtype))
        self.b = nn.Parameter(torch.empty((cout,), device=device, dtype=dtype))

    def init(self, key):
        """`conv_init(key, ...)`: U(+-1/sqrt(cin*kh*kw))."""
        kh, kw, cin, _ = self.w.shape
        _init_uniform(self, key, cin * kh * kw)

    def forward(self, x):
        w = self.w.permute(3, 2, 0, 1)
        return _conv2d(x, w, self.b,
                       _pads(x, w.shape[-1], self.padding, self.stride),
                       self.stride)


class Dense(nn.Module):
    """`x @ w + b` with a (din, dout) weight."""

    def __init__(self, din, dout, device=None, dtype=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty((din, dout), device=device,
                                          dtype=dtype))
        self.b = nn.Parameter(torch.empty((dout,), device=device, dtype=dtype))

    def init(self, key):
        """`dense_init(key, ...)`: W, b ~ U(+-1/sqrt(din))."""
        _init_uniform(self, key, self.w.shape[0])

    def forward(self, x):
        return x @ self.w + self.b


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis 1 of an NCHW activation; parameters
    `gamma`, `beta`, running-stat buffers `mean`, `var`."""

    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        like = {"device": device, "dtype": dtype}
        self.gamma = nn.Parameter(torch.ones((c,), **like))
        self.beta = nn.Parameter(torch.zeros((c,), **like))
        self.register_buffer("mean", torch.zeros((c,), **like))
        self.register_buffer("var", torch.ones((c,), **like))

    @torch.no_grad()
    def init(self):
        """`batchnorm_init`: gamma 1, beta 0, mean 0, var 1."""
        self.gamma.fill_(1.0)
        self.beta.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, train):
        """Returns `(out, new_state)` with `new_state = {"mean", "var"}`
        folded from this batch in train mode, unchanged in eval mode.
        `out` has `x.dtype`, `new_state` the state's dtype."""
        if not train:
            out = batchnorm_eval(x, self.gamma, self.beta, self.mean, self.var)
            return out, {"mean": self.mean, "var": self.var}
        out, mean, unbiased = batchnorm_train(x, self.gamma, self.beta)
        return out, fold_running_stats(self.mean, self.var, mean, unbiased)


def batchnorm_train(x, gamma, beta):
    """Train-mode BatchNorm over the channel axis 1 of an NCHW activation:
    `(out, batch mean, unbiased batch variance)`. The statistics are taken
    at `promote_types(x.dtype, float32)` and detached (the running stats
    are aux state: no gradient flows into them); `out` has x.dtype."""
    return _batchnorm_train(x, gamma, beta, dims=(0, 2, 3),
                            shape=(1, -1, 1, 1))


def _batchnorm_train(x, gamma, beta, dims, shape):
    """`batchnorm_train` with statistics over `dims` of x, shaped as
    `gamma`, broadcast back to x as `shape`."""
    count = x.numel() // gamma.numel()
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=dims)
    var = xf.var(dim=dims, correction=0)
    inv = torch.rsqrt(var + BN_EPS)
    out = (x - mean.view(shape)) * (inv * gamma).view(shape)
    out = (out + beta.view(shape)).to(x.dtype)
    mean, var = mean.detach(), var.detach()
    return out, mean, var * (count / max(count - 1, 1))


def batchnorm_eval(x, gamma, beta, mean, var, shape=(1, -1, 1, 1)):
    """Eval-mode BatchNorm on the running stats, broadcast to x as `shape`
    (the channel axis 1 by default). With f32 running stats under a half
    compute dtype the arithmetic promotes; the activation comes back in
    x.dtype."""
    inv = torch.rsqrt(var + BN_EPS)
    out = (x - mean.view(shape)) * (inv * gamma).view(shape)
    return (out + beta.view(shape)).to(x.dtype)


def fold_running_stats(mean0, var0, mean, unbiased):
    """`r <- (1-m) r + m s` from the state `(mean0, var0)`, in the state's
    dtype; `mean`, `unbiased` may carry a leading worker axis."""
    sdt = mean0.dtype
    return {"mean": ((1 - BN_MOMENTUM) * mean0 + BN_MOMENTUM * mean).to(sdt),
            "var": ((1 - BN_MOMENTUM) * var0 + BN_MOMENTUM * unbiased).to(sdt)}


def _to_groups(x, S):
    """Worker-major `(S*B, C, ...)` -> worker-grouped `(B, S*C, ...)`."""
    x = x.reshape(S, -1, *x.shape[1:]).transpose(0, 1)
    return x.reshape(x.shape[0], -1, *x.shape[3:])


def _from_groups(x, S):
    """Worker-grouped `(B, S*C, ...)` -> worker-major `(S*B, C, ...)`."""
    x = x.reshape(x.shape[0], S, -1, *x.shape[2:]).transpose(0, 1)
    return x.reshape(-1, *x.shape[2:])


class _WorkerConv(torch.autograd.Function):
    """Convolutions of S workers on worker-major batches at `stride`, with
    `pads` `(top, bottom, left, right)`; see `grouped_conv`. `w: (S, cout,
    cin, kh, kw)`, `b: (S, cout)`. Symmetric pads are the convolutions'
    own padding; others pad the input first, and the input gradient is
    taken on the padded input and cropped."""

    @staticmethod
    def forward(x, w, b, shared, stride, pads):
        S = w.shape[0]
        if shared:
            return _conv2d(x, w[0], b[0], pads, stride)
        out = _from_groups(_conv2d(_to_groups(x, S),
                                   w.reshape(-1, *w.shape[2:]), None, pads,
                                   stride, groups=S), S)
        # The bias added after the convolution, as vmap adds a batched one
        out = out.view(S, -1, *out.shape[1:]) + b[:, None, :, None, None]
        return out.view(-1, *out.shape[2:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _, shared, stride, pads = inputs
        ctx.save_for_backward(x, w)
        ctx.shared = shared
        ctx.stride = stride
        ctx.pads = pads

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        S = w.shape[0]
        one, stride = [1, 1], [ctx.stride, ctx.stride]
        top, bottom, left, right = ctx.pads
        if top == bottom and left == right:
            pad, xp = [top, left], x
        else:
            pad, xp = [0, 0], F.pad(x, (left, right, top, bottom))
        gy_g, x_g = _to_groups(gy, S), _to_groups(xp, S)
        w_g = w.reshape(-1, *w.shape[2:])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            if ctx.shared:
                gx = torch.ops.aten.convolution_backward(
                    gy, xp, w[0], None, stride, pad, one, False, [0, 0], 1,
                    [True, False, False])[0]
            else:
                gx = _from_groups(torch.ops.aten.convolution_backward(
                    gy_g, x_g, w_g, None, stride, pad, one, False, [0, 0], S,
                    [True, False, False])[0], S)
            if xp is not x:
                gx = gx[..., top:top + x.shape[-2], left:left + x.shape[-1]]
        if ctx.needs_input_grad[1]:
            gw = torch.ops.aten.convolution_backward(
                gy_g, x_g, w_g, None, stride, pad, one, False, [0, 0], S,
                [False, True, False])[1].view(w.shape)
        gb = gy.reshape(S, -1, *gy.shape[1:]).sum(dim=(1, 3, 4))
        return gx, gw, gb, None, None, None


class _WorkerDense(torch.autograd.Function):
    """Dense layers of S workers; see `grouped_dense`. `x: (S, B, din)`,
    `w: (S, din, dout)`, `b: (S, dout)`."""

    @staticmethod
    def forward(x, w, b, shared):
        if shared:
            return x @ w[0] + b[0]
        return torch.bmm(x, w) + b[:, None, :]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _, shared = inputs
        ctx.save_for_backward(x, w)
        ctx.shared = shared

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = None
        if ctx.needs_input_grad[0]:
            gx = (gy @ w[0].T if ctx.shared
                  else torch.bmm(gy, w.transpose(1, 2)))
        return gx, torch.bmm(x.transpose(1, 2), gy), gy.sum(dim=1), None


def grouped_conv(x, w_s, b_s, shared=False, padding="same", stride=1):
    """Per-worker convolutions at `stride` (`padding` "same", XLA's SAME
    for a square kernel, or "valid", as `Conv`): `x: (S*B, cin, H, W)`
    worker by worker, stacked HWIO kernels `w_s: (S, kh, kw, cin, cout)`
    and biases `b_s: (S, cout)` -> `(S*B, cout, H', W')`. `shared` says
    that every worker's kernel and bias equal worker 0's: the forward and
    the input gradient are then one convolution over the S*B inputs. The
    kernel gradient is one `groups=S` convolution gradient on
    `(B, S*C, H, W)`, the calls `torch.func.vmap` makes."""
    return _WorkerConv.apply(x, w_s.permute(0, 4, 3, 1, 2), b_s, shared,
                             stride, _pads(x, w_s.shape[1], padding, stride))


def grouped_dense(x, w_s, b_s, shared=False):
    """Per-worker dense layers: `x: (S, B, din)`, `w_s: (S, din, dout)`,
    `b_s: (S, dout)` -> `(S, B, dout)`; `shared` as in
    `grouped_conv` (one matmul over the S*B rows)."""
    return _WorkerDense.apply(x, w_s, b_s, shared)


def grouped_batchnorm(x, gamma_s, beta_s, mean, var, train):
    """Per-worker BatchNorm on `x: (S*B, C, H, W)` with parameters
    `(S, C)` and the shared running stats `mean`, `var: (C,)`. Train mode
    returns the per-worker running-stat updates as `(S, C)` leaves (for
    `engine/step.py::compose_bn_updates`); eval mode the shared state."""
    S, C = gamma_s.shape
    xs = x.view(S, -1, *x.shape[1:])
    shape = (S, 1, C, 1, 1)
    if not train:
        out = batchnorm_eval(xs, gamma_s, beta_s, mean.expand(S, C),
                             var.expand(S, C), shape)
        return out.view(x.shape), {"mean": mean, "var": var}
    out, batch_mean, unbiased = _batchnorm_train(
        xs, gamma_s, beta_s, dims=(1, 3, 4), shape=shape)
    return out.view(x.shape), fold_running_stats(mean, var, batch_mean,
                                                 unbiased)


def _threshold(keep):
    """The 8-bit threshold `keep * 256` where it is an integer in
    1..255, else None (`_dropout_mask`'s branch)."""
    t = keep * 256.0
    return int(t) if t == int(t) and 0 < t < 256 else None


def worker_dropout_masks(wkeys, j, keep, shape):
    """The keep-masks of S workers' dropout layer j: worker s's is the JAX
    package's `_dropout_mask(split(wkeys[s], n)[j], keep, shape)` (any
    n > j: `bits8 < keep * 256` where that is an 8-bit threshold, else
    `bernoulli(keep)`), the JAX shape `(B, H, W, C)` or `(B, F)` -> the
    port's layout
    `bool[S, B, C, H, W]` or `bool[S, B, F]`. An 8-bit keep threshold
    goes through `prng_kernels.dropout_masks`, any other rate through
    `prng_kernels.bernoulli_masks` (each the CUDA kernel on the card,
    `prng.bits8` or `prng.bernoulli` on the CPU)."""
    t = _threshold(keep)
    if t is not None:
        return prng_kernels.dropout_masks(wkeys, j, shape, t)
    return prng_kernels.bernoulli_masks(wkeys, j, shape, keep)


def dropout_apply(mask, x, rate):
    """Inverted dropout with a given keep-mask (torch semantics: scale by
    1/(1-p) at train time, p rounded to x's dtype as JAX applies it);
    `mask=None` is the eval-mode identity."""
    if mask is None:
        return x
    keep = weak_scalar(1.0 - rate, x.dtype)
    return torch.where(mask, x / keep, 0.0)


def max_pool(x, window=2):
    return F.max_pool2d(x, window)


def global_avg_pool(x):
    """The mean over the spatial axes of an NCHW activation, `(N, C)`
    (`jnp.mean(x, axis=(1, 2))` on NHWC: a half dtype sums in f32)."""
    return x.mean(dim=(2, 3))


def log_softmax(x):
    return F.log_softmax(x, dim=-1)


# --------------------------------------------------------------------------- #
# Named inits (`--init-multi` / `--init-mono`,
# `byzantinemomentum_tpu/models/core.py::inits`): each draws a float32
# leaf of the JAX shape from its key, as the JAX function does; Python
# scalars (mean, std, gain, bounds) apply as float32 weak scalars, one
# rounding an operation

def _fans(shape):
    if len(shape) < 2:
        fan = shape[0] if shape else 1
        return fan, fan
    receptive = math.prod(shape[:-2])
    # HWIO kernels / (din, dout) dense matrices
    return shape[-2] * receptive, shape[-1] * receptive


def _gain(nonlinearity, a=0.0):
    if nonlinearity in ("sigmoid", "linear"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + a * a))
    return 1.0


def _scaled(scale, x):
    """`scale * x` for a Python scale and an f32 tensor."""
    return weak_scalar(scale, torch.float32) * x


def _init_uniform_named(key, shape, a=0.0, b=1.0, **kw):
    return prng.uniform(key, shape, torch.float32, a, b)


def _init_normal(key, shape, mean=0.0, std=1.0, **kw):
    return weak_scalar(mean, torch.float32) + _scaled(std, prng.normal(key, shape))


def _init_constant(key, shape, val=0.0, **kw):
    return torch.full(shape, val, dtype=torch.float32, device=key.device)


def _init_ones(key, shape, **kw):
    return torch.ones(shape, dtype=torch.float32, device=key.device)


def _init_zeros(key, shape, **kw):
    return torch.zeros(shape, dtype=torch.float32, device=key.device)


def _init_xavier_uniform(key, shape, gain=1.0, **kw):
    fan_in, fan_out = _fans(shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return prng.uniform(key, shape, torch.float32, -bound, bound)


def _init_xavier_normal(key, shape, gain=1.0, **kw):
    fan_in, fan_out = _fans(shape)
    return _scaled(gain * math.sqrt(2.0 / (fan_in + fan_out)),
                   prng.normal(key, shape))


def _init_kaiming_uniform(key, shape, a=0.0, mode="fan_in",
                          nonlinearity="leaky_relu", **kw):
    fan_in, fan_out = _fans(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    bound = _gain(nonlinearity, a) * math.sqrt(3.0 / fan)
    return prng.uniform(key, shape, torch.float32, -bound, bound)


def _init_kaiming_normal(key, shape, a=0.0, mode="fan_in",
                         nonlinearity="leaky_relu", **kw):
    fan_in, fan_out = _fans(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    return _scaled(_gain(nonlinearity, a) / math.sqrt(fan),
                   prng.normal(key, shape))


def _init_orthogonal(key, shape, gain=1.0, **kw):
    """`jax.nn.initializers.orthogonal()`: the QR of a normal
    `(max(r, c), min(r, c))` matrix (r = prod(shape) / c rows, c =
    shape[-1] columns), Q's columns times the signs of R's diagonal,
    transposed where r < c, then reshaped to `shape`; times 1.0, then
    `gain`."""
    if len(shape) < 2:
        raise ValueError("orthogonal initializer requires at least a 2D shape")
    cols = shape[-1]
    rows = math.prod(shape) // cols
    z = prng.normal(key, (max(rows, cols), min(rows, cols)))
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return _scaled(gain, q.reshape(shape).contiguous())


def _init_trunc_normal(key, shape, mean=0.0, std=1.0, a=-2.0, b=2.0, **kw):
    """torch `trunc_normal_`: N(mean, std) truncated to values in [a, b]."""
    lo = (a - mean) / std
    hi = (b - mean) / std
    return weak_scalar(mean, torch.float32) + _scaled(
        std, prng.truncated_normal(key, lo, hi, shape))


def _init_eye(key, shape, **kw):
    """torch `eye_`: the 2D identity."""
    if len(shape) != 2:
        raise ValueError("eye init requires a 2-dimensional parameter")
    return torch.eye(shape[0], shape[1], dtype=torch.float32, device=key.device)


def _init_dirac(key, shape, groups=1, **kw):
    """torch `dirac_` in HWIO layout: the {3,4,5}D kernel that keeps each
    channel (a delta at the spatial center, per group)."""
    if len(shape) not in (3, 4, 5):
        raise ValueError("dirac init requires a {3,4,5}-dimensional kernel")
    spatial, cin, cout = shape[:-2], shape[-2], shape[-1]
    if cout % groups != 0:
        raise ValueError("out channels must be divisible by groups")
    per_group = cout // groups
    w = torch.zeros(shape, dtype=torch.float32, device=key.device)
    center = tuple(s // 2 for s in spatial)
    for g in range(groups):
        for d in range(min(per_group, cin)):
            w[center + (d, g * per_group + d)] = 1.0
    return w


def _init_sparse(key, shape, sparsity=0.1, std=0.01, **kw):
    """torch `sparse_`: an N(0, std) 2D matrix with ceil(sparsity * rows)
    entries of each column zeroed, those of the smallest uniform ranks."""
    if len(shape) != 2:
        raise ValueError("sparse init requires a 2-dimensional parameter")
    rows, _ = shape
    nz = math.ceil(sparsity * rows)
    kn, kp = prng.split(key)
    w = _scaled(std, prng.normal(kn, shape))
    if nz <= 0:
        return w
    u = prng.uniform(kp, shape)
    thresh = torch.sort(u, dim=0).values[nz - 1]
    # +0 where zeroed, as XLA gives `w * (u > thresh)`
    return torch.where(u > thresh, w, 0.0)


inits = {
    "uniform": _init_uniform_named,
    "normal": _init_normal,
    "trunc_normal": _init_trunc_normal,
    "constant": _init_constant,
    "ones": _init_ones,
    "zeros": _init_zeros,
    "eye": _init_eye,
    "dirac": _init_dirac,
    "xavier_uniform": _init_xavier_uniform,
    "xavier_normal": _init_xavier_normal,
    "kaiming_uniform": _init_kaiming_uniform,
    "kaiming_normal": _init_kaiming_normal,
    "orthogonal": _init_orthogonal,
    "sparse": _init_sparse,
}
# The torch in-place spellings too ("xavier_uniform_", ...)
inits.update({name + "_": init for name, init in list(inits.items())})


@torch.no_grad()
def apply_named_init(model, key, init_multi=None, init_multi_args=None,
                     init_mono=None, init_mono_args=None):
    """Re-initialize the model's parameters of two or more dimensions with
    `init_multi` and those of fewer with `init_mono` (the JAX
    `apply_named_init`): one key a parameter from `split(key, count)` in
    `jax.tree.flatten`'s leaf order (the names sorted component by
    component, `FlatParams.names`), each drawn in float32 in its JAX
    shape and rounded to the parameter dtype."""
    named = dict(model.named_parameters())
    names = sorted(named, key=lambda name: tuple(name.split(".")))
    keys = prng.split(key.to(next(iter(named.values())).device), len(names))
    for name, leaf_key in zip(names, keys):
        leaf = named[name]
        if leaf.dim() >= 2 and init_multi is not None:
            init, args = inits[init_multi], init_multi_args
        elif leaf.dim() < 2 and init_mono is not None:
            init, args = inits[init_mono], init_mono_args
        else:
            continue
        leaf.copy_(init(leaf_key, tuple(leaf.shape), **(args or {})))
    return model
