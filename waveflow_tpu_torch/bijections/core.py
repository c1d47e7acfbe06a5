"""Bijection combinators — the layer protocol of the port.

Port of waveflow_tpu/bijections/core.py.  A layer is an ``nn.Module`` with
``forward(x) -> (y, log_det)`` and ``inverse(y) -> (x, log_det)`` over a
(batch, dim) tensor; what the JAX package draws from a PRNG key at init
(orthogonal matrices, permutations) the port draws from an explicit
``torch.Generator`` or takes as an argument.
"""

from __future__ import annotations

import torch
from torch import nn


def _full(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A (batch,) log-det of one value for every row."""
    return value.expand(x.shape[:1])


def _orthogonal(n: int, generator, device) -> torch.Tensor:
    """A random orthogonal (n, n) matrix: QR of a Gaussian matrix, the
    signs fixed by R's diagonal (the distribution of JAX's ``orthogonal``
    initializer)."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=generator,
                                       dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))).float().to(device)


class ActNorm(nn.Module):
    """Activation normalization (Glow): (x − bias) · exp(log_weight).
    With ``init_inputs`` the data-dependent init: bias the batch mean,
    exp(log_weight) = 1 / (std + 1e-6) (population std)."""

    def __init__(self, input_dim: int, init_inputs: torch.Tensor | None = None,
                 *, device=None):
        super().__init__()
        if init_inputs is not None:
            init_inputs = init_inputs.to(device)
            log_weight = torch.log(1.0 / (init_inputs.std(0, correction=0)
                                          + 1e-6))
            bias = init_inputs.mean(0)
        else:
            log_weight = torch.zeros(input_dim, device=device)
            bias = torch.zeros(input_dim, device=device)
        self.log_weight = nn.Parameter(log_weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor):
        return ((x - self.bias) * torch.exp(self.log_weight),
                _full(x, self.log_weight.sum()))

    def inverse(self, y: torch.Tensor):
        return (y * torch.exp(-self.log_weight) + self.bias,
                _full(y, -self.log_weight.sum()))


class AffineCoupling(nn.Module):
    """RealNVP coupling: the lower half (``input_dim // 2``) conditions an
    affine map of the upper half; ``transform_factory(d_in, d_out, *,
    generator, device)`` builds the network, which emits the concatenated
    (log_scale, shift)."""

    def __init__(self, transform_factory, input_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cutoff = input_dim // 2
        self.transform = transform_factory(
            self.cutoff, 2 * (input_dim - self.cutoff), generator=generator,
            device=device)

    def _scale_shift(self, lower):
        return self.transform(lower).chunk(2, dim=1)

    def forward(self, x: torch.Tensor):
        lower, upper = x[:, :self.cutoff], x[:, self.cutoff:]
        log_weight, bias = self._scale_shift(lower)
        return (torch.cat([lower, upper * torch.exp(log_weight) + bias], 1),
                log_weight.sum(-1))

    def inverse(self, y: torch.Tensor):
        lower, upper = y[:, :self.cutoff], y[:, self.cutoff:]
        log_weight, bias = self._scale_shift(lower)
        # the JAX package returns +Σ log_weight here too
        return (torch.cat([lower, (upper - bias) * torch.exp(-log_weight)], 1),
                log_weight.sum(-1))


class AffineCouplingSplit(AffineCoupling):
    """RealNVP coupling with separate scale and translate networks,
    ``scale_factory`` / ``translate_factory(d_in, d_out, *, generator,
    device)``, each (batch, d_in) -> (batch, input_dim − d_in)."""

    def __init__(self, scale_factory, translate_factory, input_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        nn.Module.__init__(self)
        self.cutoff = input_dim // 2
        d_out = input_dim - self.cutoff
        self.scale = scale_factory(self.cutoff, d_out, generator=generator,
                                   device=device)
        self.translate = translate_factory(self.cutoff, d_out,
                                           generator=generator, device=device)

    def _scale_shift(self, lower):
        return self.scale(lower), self.translate(lower)


class BatchNorm(nn.Module):
    """Invertible normalization by stored statistics (JAX's pure form):
    ((x − mean) / √var) · exp(log_weight) + bias, with ``mean`` and ``var``
    buffers that take no gradient, so the direct and inverse maps are exact
    inverses under any transform.  ``init_inputs`` sets them from data;
    ``batchnorm_update_stats`` folds batch moments in between steps."""

    def __init__(self, input_dim: int, momentum: float = 0.9,
                 eps: float = 1e-5, init_inputs: torch.Tensor | None = None,
                 *, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        if init_inputs is not None:
            init_inputs = init_inputs.to(device)
            mean = init_inputs.mean(0)
            var = init_inputs.var(0, correction=0) + eps
        else:
            mean = torch.zeros(input_dim, device=device)
            var = torch.ones(input_dim, device=device)
        self.log_weight = nn.Parameter(torch.zeros(input_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(input_dim, device=device))
        self.register_buffer('mean', mean)
        self.register_buffer('var', var)

    def forward(self, x: torch.Tensor):
        x_hat = (x - self.mean) / torch.sqrt(self.var)
        return (x_hat * torch.exp(self.log_weight) + self.bias,
                _full(x, (self.log_weight - 0.5 * torch.log(self.var)).sum()))

    def inverse(self, y: torch.Tensor):
        x_hat = (y - self.bias) * torch.exp(-self.log_weight)
        return (x_hat * torch.sqrt(self.var) + self.mean,
                _full(y, (-self.log_weight
                          + 0.5 * torch.log(self.var)).sum()))


@torch.no_grad()
def batchnorm_update_stats(layer: BatchNorm, batch: torch.Tensor,
                           momentum: float = 0.9, eps: float = 1e-5):
    """EMA-fold a batch's moments into a ``BatchNorm``'s statistics, in
    place (the JAX function returns new params; log_weight and bias are
    untouched either way).  Returns the layer."""
    layer.mean.copy_(momentum * layer.mean + (1 - momentum) * batch.mean(0))
    layer.var.copy_(momentum * layer.var
                    + (1 - momentum) * (batch.var(0, correction=0) + eps))
    return layer


class Invert(nn.Module):
    """A layer with its direct and inverse maps swapped."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    def forward(self, x: torch.Tensor):
        return self.layer.inverse(x)

    def inverse(self, y: torch.Tensor):
        return self.layer(y)


class FixedInvertibleLinear(nn.Module):
    """A fixed invertible linear map x @ W: ``weight`` if given, else a
    random orthogonal matrix from ``generator``; no parameters."""

    def __init__(self, input_dim: int, weight: torch.Tensor | None = None,
                 *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        W = (_orthogonal(input_dim, generator, device) if weight is None
             else torch.as_tensor(weight, dtype=torch.float32, device=device))
        self.register_buffer('W', W)
        self.register_buffer('W_inv', torch.linalg.inv(W))
        self.register_buffer('W_log_det', torch.linalg.slogdet(W)[1])

    def forward(self, x: torch.Tensor):
        return x @ self.W, _full(x, self.W_log_det)

    def inverse(self, y: torch.Tensor):
        return y @ self.W_inv, _full(y, -self.W_log_det)


class InvertibleLinear(nn.Module):
    """A trainable invertible linear map in the PLU parameterization,
    W = P (L + I) (U + diag S) with L strictly lower and U strictly upper,
    from the LU factors of ``weight`` (else a random orthogonal matrix
    from ``generator``); log-det Σ log|S|."""

    def __init__(self, input_dim: int, weight: torch.Tensor | None = None,
                 *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        W = (_orthogonal(input_dim, generator, device) if weight is None
             else torch.as_tensor(weight, dtype=torch.float32, device=device))
        P, L, U = torch.linalg.lu(W)
        self.register_buffer('P', P)
        self.register_buffer('identity', torch.eye(input_dim, device=device))
        self.L = nn.Parameter(L)
        self.U = nn.Parameter(torch.triu(U, 1))
        self.S = nn.Parameter(torch.diagonal(U).clone())

    def weight(self) -> torch.Tensor:
        L = torch.tril(self.L, -1) + self.identity
        return self.P @ L @ (torch.triu(self.U, 1) + torch.diag(self.S))

    def forward(self, x: torch.Tensor):
        return x @ self.weight(), _full(x, torch.log(self.S.abs()).sum())

    def inverse(self, y: torch.Tensor):
        return (y @ torch.linalg.inv(self.weight()),
                _full(y, -torch.log(self.S.abs()).sum()))


class Sigmoid(nn.Module):
    """Elementwise sigmoid with the logit as inverse; the inverse clips
    its input to [1e-5, 1 − 1e-5] first unless ``clip_before_logit`` is
    False."""

    def __init__(self, clip_before_logit: bool = True):
        super().__init__()
        self.clip_before_logit = clip_before_logit

    def forward(self, x: torch.Tensor):
        s = torch.sigmoid(x)
        return s, torch.log(s * (1 - s)).sum(-1)

    def inverse(self, y: torch.Tensor):
        if self.clip_before_logit:
            y = torch.clamp(y, 1e-5, 1 - 1e-5)
        return torch.logit(y), -torch.log(y - y * y).sum(-1)


def Logit(clip_before_logit: bool = True) -> Invert:
    """The logit, with the sigmoid as inverse."""
    return Invert(Sigmoid(clip_before_logit))


class Shuffle(nn.Module):
    """A fixed permutation of the coordinates: ``perm`` if given, else a
    random one from ``generator``."""

    def __init__(self, input_dim: int, perm=None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        perm = (torch.randperm(input_dim, generator=generator) if perm is None
                else torch.as_tensor(perm, dtype=torch.long))
        self.register_buffer('perm', perm.to(device))
        self.register_buffer('inv_perm', torch.argsort(perm).to(device))

    def forward(self, x: torch.Tensor):
        return x[:, self.perm], x.new_zeros(x.shape[:1])

    def inverse(self, y: torch.Tensor):
        return y[:, self.inv_perm], y.new_zeros(y.shape[:1])


class Reverse(nn.Module):
    """Static dimension reversal."""

    def forward(self, x: torch.Tensor):
        return x.flip(-1), x.new_zeros(x.shape[:1])

    def inverse(self, y: torch.Tensor):
        return y.flip(-1), y.new_zeros(y.shape[:1])


class MADE(nn.Module):
    """Affine masked autoregressive layer.

    ``transform_factory(input_dim, *, generator, device)`` builds the masked
    network (``simple_masked_transform()``), which emits (batch, 2 *
    input_dim) concatenated (log_scale, shift)."""

    def __init__(self, transform_factory, input_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.transform = transform_factory(input_dim, generator=generator,
                                           device=device)

    def forward(self, x: torch.Tensor):
        log_weight, bias = self.transform(x).chunk(2, dim=1)
        return (x - bias) * torch.exp(-log_weight), -log_weight.sum(-1)

    def inverse(self, y: torch.Tensor):
        # column i's (log_weight, bias) depend only on columns < i, which
        # are final by iteration i, so the per-column log-dets summed in the
        # loop are the true inverse log-det +Σ log_weight(x)
        outputs = torch.zeros_like(y)
        log_det = y.new_zeros(y.shape[:1])
        cols = torch.arange(y.shape[1], device=y.device)
        for i_col in range(y.shape[1]):
            log_weight, bias = self.transform(outputs).chunk(2, dim=1)
            col = y[:, i_col] * torch.exp(log_weight[:, i_col]) + bias[:, i_col]
            outputs = torch.where(cols == i_col, col[:, None], outputs)
            log_det = log_det + log_weight[:, i_col]
        return outputs, log_det


class Serial(nn.Module):
    """Sequential composition; accumulates log-dets."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        log_det = x.new_zeros(x.shape[:1])
        for layer in self.layers:
            x, ldj = layer(x)
            log_det = log_det + ldj
        return x, log_det

    def inverse(self, y: torch.Tensor):
        log_det = y.new_zeros(y.shape[:1])
        for layer in reversed(self.layers):
            y, ldj = layer.inverse(y)
            log_det = log_det + ldj
        return y, log_det
