"""The codec's mathematics in plain PyTorch, as the reference LBDRN-MSIC
describes it (reference LBDRNdataset.py:92-133, LBDRNmodel.py:7-82,
encode.py:67-157, decode.py:73-135), for the benchmark's judge.  It
imports nothing of the program.

- The base layer of a scene at K is ``scene >> K``; its LSBs are the label,
  normalised by 1/(2^K - 1).
- A pixel's features are its (2D+1)^2 neighbours in each band (reflect
  padding), band after band, row-major, minus the centre tap ("relative
  colours"), times 1/max of the base plane.  The stream format fixes the
  arithmetic as ``float32(tap - centre) * float32(1 / max)``.
- The network: ``num_layers`` hidden layers ``sin(30 * (h W + b))`` and a
  sigmoid head; its init draws W and b from U(-s, s), s = 1/dim_in in the
  first layer and sqrt(6/dim_in)/30 after it.
- The decode: ``residual = round(pred * (2^K - 1))`` (half to even),
  ``image = (base << K) + residual``.
- Training: the masked mean squared error over the batch's rows and bands,
  and Adam (0.9, 0.999, 1e-8) with torch's bias correction.

Everything runs in float32 with TF32 off, in row blocks; `dtype`
bfloat16 gives the control's lower precision.
"""

from __future__ import annotations

import numpy as np
import torch

W0 = 30.0
ADAM = (0.9, 0.999, 1e-8)
BLOCK_ROWS = 256


def feature_dims(C: int, D: int, bc: int, nl: int) -> list:
    return [C * (2 * D + 1) ** 2] + [bc] * nl + [C]


def _reflect(n: int, D: int, device) -> torch.Tensor:
    idx = torch.arange(-D, n + D, device=device)
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


class BasePlane:
    """The base layer of a scene at K on `device`, reflect-padded, with
    its normaliser and its LSB labels."""

    def __init__(self, scene: np.ndarray, K: int, D: int, device):
        img = torch.from_numpy(scene.astype(np.int32)).to(device)
        self.K, self.D = K, D
        self.C, self.H, self.W = img.shape
        self.msb = img >> K
        self.lsb = img - (self.msb << K)
        mx = max(int(self.msb.max()), 1)
        self.scale = torch.tensor(np.float32(1.0) / np.float32(mx), device=device)
        self.padded = self.msb[:, _reflect(self.H, D, device)][:, :, _reflect(self.W, D, device)]
        self.lsb_peak = float(np.float32((1 << K) - 1))
        self.label_scale = float(np.float32(1.0 / float((1 << K) - 1)))

    def features(self, r0: int, R: int, relative: bool = True) -> torch.Tensor:
        """(R*W, C*(2D+1)^2) float32 features of rows [r0, r0 + R)."""
        side = 2 * self.D + 1
        blk = self.padded[:, r0: r0 + R + 2 * self.D]
        taps = torch.stack([blk[:, di: di + R, dj: dj + self.W]
                            for di in range(side) for dj in range(side)], dim=1)
        if relative and self.D > 0:
            taps = taps - taps[:, (side * side) // 2][:, None]
        return taps.permute(2, 3, 0, 1).reshape(R * self.W, -1).to(torch.float32) * self.scale

    def labels(self, r0: int, R: int) -> torch.Tensor:
        """(R*W, C) float32 labels of rows [r0, r0 + R)."""
        lsb = self.lsb[:, r0: r0 + R].permute(1, 2, 0).reshape(R * self.W, self.C)
        return lsb.to(torch.float32) * self.label_scale

    def blocks(self):
        for r0 in range(0, self.H, BLOCK_ROWS):
            yield r0, min(BLOCK_ROWS, self.H - r0)


def layers_from_flat(flat: np.ndarray, dims: list, device) -> list:
    """The weights stream's vector -> [(W (out, in), b (out,))], the
    reference's state-dict order: per layer the weight row-major, then the
    bias."""
    out, k = [], 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.from_numpy(flat[k: k + d_in * d_out].reshape(d_out, d_in).copy())
        k += d_in * d_out
        b = torch.from_numpy(flat[k: k + d_out].copy())
        k += d_out
        out.append((w.to(device), b.to(device)))
    if k != flat.size:
        raise ValueError(f"weights hold {flat.size} values, the network {k}")
    return out


def forward(layers: list, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """SIREN forward: hidden sin(30 (h W^T + b)), sigmoid head."""
    h = x.to(dtype)
    for w, b in layers[:-1]:
        h = torch.sin(W0 * (h @ w.to(dtype).T + b.to(dtype)))
    w, b = layers[-1]
    return torch.sigmoid(h @ w.to(dtype).T + b.to(dtype)).to(torch.float32)


def judge_decode(plane: BasePlane, layers: list, decoded: np.ndarray, relative: bool = True,
                 dtype=torch.float32) -> dict:
    """The program's decode of a stream against the reference's, block by
    block: sub-pixels whose MSBs differ from the scene's, sub-pixels whose
    value differs from the reference reconstruction, and the network's
    squared error on the LSBs before rounding, beside that of the
    constant mid-point prediction, and its mean in the labels' scale
    (the LSBs over 2^K - 1), the scale in which the program's eval reads
    it."""
    dev = plane.msb.device
    dec = torch.from_numpy(decoded.astype(np.int32)).to(dev)
    K = plane.K
    msb_wrong = int(((dec >> K) != plane.msb).sum())
    flips, sse_net, sse_mid = 0, 0.0, 0.0
    with torch.no_grad():
        for r0, R in plane.blocks():
            pred = forward(layers, plane.features(r0, R, relative), dtype)
            res = torch.round(pred * plane.lsb_peak).to(torch.int32)
            res = res.reshape(R, plane.W, plane.C).permute(2, 0, 1)
            rec = (plane.msb[:, r0: r0 + R] << K) + res
            flips += int((rec != dec[:, r0: r0 + R]).sum())
            lsb = plane.lsb[:, r0: r0 + R].to(torch.float64)
            cont = (pred.to(torch.float64) * plane.lsb_peak).reshape(R, plane.W, plane.C)
            sse_net += float(((cont.permute(2, 0, 1) - lsb) ** 2).sum())
            sse_mid += float(((lsb - plane.lsb_peak / 2) ** 2).sum())
    return {"msb_wrong": msb_wrong, "flips": flips, "n": dec.numel(),
            "mse_ratio": sse_net / max(sse_mid, 1e-30),
            "mse": sse_net / (plane.lsb_peak ** 2 * dec.numel())}


def init_violations(weights: list, biases: list, dims: list) -> int:
    """Entries of a network at its init that lie outside the scheme's
    U(-s, s) (the program's layout: weights (in, out), the first layer's
    input rows zero-padded; padding rows must be 0)."""
    bad = 0
    for l, (w, b) in enumerate(zip(weights, biases)):
        d_in = dims[l]
        s = np.float32(1.0 / d_in) if l == 0 else np.float32(np.sqrt(6.0 / d_in) / W0)
        bad += int((w[:d_in].abs() > float(s)).sum()) + int((b.abs() > float(s)).sum())
        bad += int((w[d_in:] != 0).sum())
    return bad


def train_step(ws: list, bs: list, m: list, v: list, x, y, mask, lr: float, t: int):
    """One Adam step of the masked MSE in float32 autograd.  Leaves in the
    program's layout (weights (in, out), biases (out,)); returns (new
    leaves, new m, new v, loss, the gradients)."""
    leaves = [p.detach().clone().requires_grad_(True) for p in ws + bs]
    L = len(ws)
    C = y.shape[1]
    with torch.enable_grad():
        h = x
        for i in range(L - 1):
            h = torch.sin(W0 * (h @ leaves[i] + leaves[L + i]))
        pred = torch.sigmoid(h @ leaves[L - 1] + leaves[2 * L - 1])
        se = (((pred - y) ** 2) * mask[:, None]).sum()
        loss = se / (torch.clamp(mask.sum(), min=1.0) * C)
        grads = torch.autograd.grad(loss, leaves)
    b1, b2, eps = ADAM
    tt = np.float32(t)
    c1 = float(np.float32(1) / (np.float32(1) - np.float32(b1) ** tt))
    c2 = float(np.float32(1) / (np.float32(1) - np.float32(b2) ** tt))
    lr = float(np.float32(lr))
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for p, g, mm, vv in zip(leaves, grads, m, v):
            mm = b1 * mm + (1.0 - b1) * g
            vv = b2 * vv + (1.0 - b2) * g * g
            new_p.append(p - lr * (mm * c1) / (torch.sqrt(vv * c2) + eps))
            new_m.append(mm)
            new_v.append(vv)
    return new_p, new_m, new_v, float(loss.detach()), list(grads)


_HASH = ((1000003, 2147483647), (999331, 2147483629))


def row_keys(a: torch.Tensor) -> torch.Tensor:
    """A 62-bit key of each row's float32 bit patterns: two polynomial
    hashes modulo primes below 2^31 (no int64 product overflows)."""
    v = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keys = []
    for p, q in _HASH:
        h = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
        for j in range(a.shape[1]):
            h = (h * p + v[:, j]) % q
        keys.append(h)
    return keys[0] * q + keys[1]


def reconstruct(plane: BasePlane, layers: list, relative: bool = True,
                dtype=torch.float32) -> np.ndarray:
    """The reference decode of the whole scene at `dtype`: (C, H, W)."""
    out = torch.empty((plane.C, plane.H, plane.W), dtype=torch.int32, device=plane.msb.device)
    with torch.no_grad():
        for r0, R in plane.blocks():
            pred = forward(layers, plane.features(r0, R, relative), dtype)
            res = torch.round(pred * plane.lsb_peak).to(torch.int32)
            out[:, r0: r0 + R] = ((plane.msb[:, r0: r0 + R] << plane.K)
                                  + res.reshape(R, plane.W, plane.C).permute(2, 0, 1))
    return out.cpu().numpy()
