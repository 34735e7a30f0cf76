"""Plain reference of one MiniConv split decision, and the comparison that
decides a run's ``correct``.

Written from the paper's description (arXiv:2512.19726, sections 3-4) and
the configuration file alone; it imports nothing of the program.  One
decision is:

1. the encoder: each layer a SAME convolution, computed as the shader
   passes compute it (every output pixel sums its kernel's taps of the
   zero-padded input; one pass writes 4 output channels), then the
   layer's activation;
2. the wire codec: per-example affine quantisation of the feature map to
   uint8 (``scale = max(hi - lo, 1e-8) / 255``, ``zero = lo``, codes
   ``round((f - lo) / scale)`` clamped to [0, 255]) and its inverse;
3. the server: the flattened (h, w, c) features times a dense projection
   plus bias, then ReLU.

Everything is float32 with TF32 off.  ``precision="tf32"`` is the
control: the same arithmetic with every product's operands rounded to
TF32 (10 mantissa bits, round to nearest even), the rounding a TF32
tensor core applies, sums kept in float32.

The benchmark makes the weights and frames here, from the seed, on the
device, and hands the same tensors to the program and to the reference.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
        "linear": lambda x: x}


# ---------------------------------------------------------------------------
# Inputs, from the seed
# ---------------------------------------------------------------------------

def layer_shapes(config: dict) -> list[dict]:
    """The encoder's layers as the configuration file states them."""
    return [dict(l) for l in config["encoder"]["layers"]]


def out_size(x: int, stride: int) -> int:
    return -(-x // stride)


def feature_shape(config: dict) -> tuple[int, int, int]:
    h = w = config["manifest"]["h"]
    for l in layer_shapes(config):
        h, w = out_size(h, l["stride"]), out_size(w, l["stride"])
    return h, w, layer_shapes(config)[-1]["c_out"]


def make_inputs(config: dict, params: dict, seed: int,
                device) -> dict:
    """Weights and the pool of tick batches for ``seed``, drawn on
    ``device`` by one generator in two large calls.

    Conv kernels are HWIO with fan-in scaling, biases 0.1 x normal, the
    projection (F, D) with fan-in scaling and a bias; frames are
    ``pool_batches`` batches of ``frames_per_tick`` float32 NHWC frames
    whose values are k/255 (a camera's uint8 pixels, normalised).
    """
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**64)
    layers = layer_shapes(config)
    fh, fw, fk = feature_shape(config)
    n_feat, d = fh * fw * fk, config["manifest"]["head_dim"]
    shapes = []
    for l in layers:
        shapes += [(l["kernel"], l["kernel"], l["c_in"], l["c_out"]),
                   (l["c_out"],)]
    shapes += [(n_feat, d), (d,)]
    sizes = [_numel(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    parts = [p.view(s) for p, s in zip(flat.split(sizes), shapes)]
    weights = []
    for i, l in enumerate(layers):
        w, b = parts[2 * i], parts[2 * i + 1]
        w.mul_((l["kernel"] * l["kernel"] * l["c_in"]) ** -0.5)
        b.mul_(0.1)
        weights.append((w, b))
    pw, pb = parts[-2], parts[-1]
    pw.mul_(n_feat ** -0.5)
    pb.mul_(0.1)
    m = config["manifest"]
    pool = torch.randint(0, 256, (params["pool_batches"],
                                  params["frames_per_tick"], m["h"], m["h"],
                                  m["c_in"]),
                         generator=gen, device=dev, dtype=torch.uint8)
    frames = pool.to(torch.float32).div_(255.0)
    return {"layers": weights, "proj": (pw, pb), "frames": frames}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# ---------------------------------------------------------------------------
# The decision, plainly
# ---------------------------------------------------------------------------

def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even; finite values only."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for cuBLAS and cuDNN, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _operands(precision: str):
    if precision == "float32":
        return lambda t: t
    if precision == "tf32":
        return to_tf32
    raise ValueError(f"unknown precision {precision!r}")


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) zero padding of a SAME convolution; the larger
    half goes after, as TensorFlow's and XLA's SAME put it."""
    total = max((out_size(size, stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_layer(x, w, b, stride: int, activation: str, rnd) -> torch.Tensor:
    """One layer, pass by pass: x (B, H, W, C) NHWC, w (k, k, C, O)."""
    B, H, W, C = x.shape
    k = w.shape[0]
    pt, pb = same_pads(H, k, stride)
    pl, pr = same_pads(W, k, stride)
    xp = rnd(F.pad(x, (0, 0, pl, pr, pt, pb)))
    oh, ow = out_size(H, stride), out_size(W, stride)
    outs = []
    for lo in range(0, w.shape[3], 4):           # one shader pass
        wg = rnd(w[..., lo:lo + 4])
        acc = torch.zeros((B * oh * ow, wg.shape[3]), dtype=torch.float32,
                          device=x.device)
        for ky in range(k):
            for kx in range(k):
                tap = xp[:, ky:ky + stride * (oh - 1) + 1:stride,
                         kx:kx + stride * (ow - 1) + 1:stride, :]
                acc += tap.reshape(-1, C) @ wg[ky, kx]
        outs.append(acc.reshape(B, oh, ow, -1) + b[lo:lo + 4])
    return ACTS[activation](torch.cat(outs, dim=3))


def encode(config: dict, inputs: dict, frames, precision="float32"):
    """Float32 features (B, h, w, c) of ``frames``."""
    rnd = _operands(precision)
    x = frames
    with _tf32_off():
        for l, (w, b) in zip(layer_shapes(config), inputs["layers"]):
            x = conv_layer(x, w, b, l["stride"], l["activation"], rnd)
    return x


def quantise(f):
    """Per-example affine uint8 codes of ``f`` (B, ...): (codes, scale,
    zero)."""
    flat = f.reshape(f.shape[0], -1)
    lo, hi = flat.amin(1), flat.amax(1)
    scale = torch.clamp(hi - lo, min=1e-8) / 255.0
    shape = (-1,) + (1,) * (f.dim() - 1)
    q = torch.round((f - lo.view(shape)) / scale.view(shape))
    return torch.clamp(q, 0, 255).to(torch.uint8), scale, lo


def dequantise(codes, scale, zero):
    shape = (-1,) + (1,) * (codes.dim() - 1)
    return codes.to(torch.float32) * scale.view(shape) + zero.view(shape)


def serve(config: dict, inputs: dict, codes, scale, zero,
          precision="float32"):
    """The server's outputs (B, D) for one batch of payloads."""
    rnd = _operands(precision)
    pw, pb = inputs["proj"]
    x = dequantise(codes, scale, zero).reshape(codes.shape[0], -1)
    with _tf32_off():
        return torch.relu(rnd(x) @ rnd(pw) + pb)


def encode_blocks(config: dict, inputs: dict, frames, precision="float32",
                  block: int = 8):
    """``encode`` in blocks of ``block`` frames, so that it fits."""
    return torch.cat([encode(config, inputs, frames[i:i + block],
                             precision)
                      for i in range(0, frames.shape[0], block)])


def decide(config: dict, inputs: dict, frames, precision="float32",
           block: int = 8) -> dict:
    """A whole decision for a batch of frames: what the program's edge and
    server return, as a sample of ``judge`` holds it (on the host)."""
    feats = encode_blocks(config, inputs, frames, precision, block)
    codes, scale, zero = quantise(feats)
    z = serve(config, inputs, codes, scale, zero, precision)
    return {"codes": codes.cpu(), "scale": scale.cpu(), "zero": zero.cpu(),
            "z": z.cpu()}


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def gaps(config: dict, inputs: dict, sample: dict, feats) -> dict:
    """The numbers compared for one tick's answers.

    ``sample``: the tick's payload (``codes``, ``scale``, ``zero``) and
    server outputs ``z``, on the host, as produced; ``feats``: the
    reference's float32 features of the tick's frames.

    * ``feature_gap``: the widest amount, in the reference's quantisation
      steps, by which a served code's value lies off the reference's
      feature beyond the half step that rounding allows.
    * ``header_gap``: the widest shift of an example's range ends
      (``zero`` and ``zero + 255 scale``) from the reference's, in steps.
    * ``server_gap``: the widest gap between the served outputs and the
      reference server's outputs on the same payload, over the tick's
      largest reference output.
    """
    codes, scale, zero, z = (sample["codes"], sample["scale"],
                             sample["zero"], sample["z"])
    dev = feats.device
    codes, scale, zero = codes.to(dev), scale.to(dev), zero.to(dev)
    _, s_ref, z_ref = quantise(feats)
    shape = (-1,) + (1,) * (codes.dim() - 1)
    off = (dequantise(codes, scale, zero) - feats).abs() \
        - scale.view(shape) / 2
    feature_gap = (off / s_ref.view(shape)).max().clamp(min=0)
    ends = torch.maximum((zero - z_ref).abs(),
                         (zero + 255 * scale - z_ref - 255 * s_ref).abs())
    header_gap = (ends / s_ref).max()
    want = serve(config, inputs, codes, scale, zero)
    server_gap = ((z.to(dev) - want).abs().max()
                  / want.abs().max().clamp(min=1e-30))
    return {"feature_gap": float(feature_gap),
            "header_gap": float(header_gap),
            "server_gap": float(server_gap)}


def judge(config: dict, inputs: dict, kept: list, params: dict) -> dict:
    """The widest reading of each number over the kept ticks.

    ``kept``: (pool index, sample) pairs; the reference encodes each pool
    batch once, in blocks of the cell's ``reference_block`` frames (8
    where ``params``, the cell's traffic parameters, name none)."""
    block = params.get("reference_block", 8)
    readings: dict = {}
    feats: dict = {}
    for idx, sample in kept:
        if idx not in feats:
            feats[idx] = encode_blocks(config, inputs, inputs["frames"][idx],
                                       block=block)
        for k, v in gaps(config, inputs, sample, feats[idx]).items():
            readings.setdefault(k, []).append(v)
    # torch's max keeps a NaN, which then fails every limit
    return {k: float(torch.tensor(v).max()) for k, v in readings.items()}


__all__ = ["conv_layer", "decide", "dequantise", "encode", "encode_blocks",
           "feature_shape",
           "gaps", "judge", "layer_shapes", "make_inputs", "quantise",
           "same_pads", "serve", "to_tf32"]
