"""Inference graph optimization (PyTorch): folded-BN forward passes.

Counterpart of ``msid_tpu/deployment/fastpath.py``, with the same public
names. The trained weights are rewritten once into an inference form and
run through a leaner forward:

  * **Fused QKV**: the three ``[D, D]`` attention projections become one
    ``[D, 3D]`` matmul per block, with ``1/sqrt(head_dim)`` folded into the
    query weights and bias (so attention does not scale again).
  * **BatchNorm folding**: eval-mode BN is an affine and folds into the
    preceding conv's kernel and bias; the decoder runs no norm.
  * **ConvTranspose(2, 2, stride 2) as matmul + depth-to-space**: each
    input pixel makes its own 2x2 output block, so the upsample is
    ``[B*H*W, Cin] @ [Cin, 4*Cout]`` and a pixel shuffle in ``(di, dj, co)``
    order. The plain conv-transpose form (``ct``) is kept beside it.
  * **Patch embed as matmul**: non-overlapping patches flattened in
    ``(py, px, c)`` order, one ``[B*N, p*p*C] @ [p*p*C, D]`` matmul.

Three graphs come out of it. ``fast_forward`` (``optimize_for_inference`` +
``make_fast_inference_fn``) rewrites encoder and decoder. The hybrid graph
keeps the module's encoder and runs the folded conv-transpose decoder:
``make_hybrid_inference_fn`` over weights folded once by
``optimize_for_hybrid`` (serving), and ``make_hybrid_forward``, which folds
the live weights on every call (``fold_decoder``: the validation pass,
where weights change every epoch). The folds read the port's own
``nn.Module`` (or a dict of its parameters and buffers) and are plain
tensor functions, so one ``fold_decoder`` serves both.

The matrix products and convolutions here are ones the JAX package leaves
to XLA; they stay ``torch.matmul`` and cuDNN, and none of these graphs
launches a fused-block kernel. Which graph serves which batch size is the
session's choice (``deployment/inference.py``); the H100 times of the three
graphs are in ``PERF.md``.

Supported: the ``unet_light`` and ``unet_skip`` decoders with
``norm='batch'``, no ``input_fill`` stage (the graphs have no
detect/fill/conditioning prologue) and the one-embed encoder (the graphs
rebuild its patch embed and its one-token-a-patch fold, not the
group-channel encoder's); anything else raises ``ValueError``.
Public functions take and return NHWC, as the JAX package does; inside,
tensors are NCHW in shape and channels-last in memory, conv kernels stay in
torch's OIHW layout, and matmul weights are ``[in, out]``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from msid_tpu_torch.models.blocks import BN_EPS, gelu
from msid_tpu_torch.models.blocks import same_pad
from msid_tpu_torch.models.encoder import LN_EPS
from msid_tpu_torch.models.restoration import exact_fp32

Tensors = Mapping[str, torch.Tensor]


def supports_fastpath(model: nn.Module) -> bool:
    """True when the model matches the hand-scheduled graphs: a SatMAE
    restorer with a ``unet_light`` or ``unet_skip`` decoder with BatchNorm,
    no ``input_fill`` stage and the one-embed encoder (a restorer with no
    ``decoder_arch``, such as Restormer, is not one)."""
    return (getattr(model, "decoder_arch", None) in ("unet_light", "unet_skip")
            and model.decoder.head_norm.kind == "batch"
            and not getattr(model, "input_fill", False)
            and getattr(model, "channel_groups", None) is None)


def _refuse_unsupported(model: nn.Module, what: str) -> None:
    if not hasattr(model, "decoder_arch"):
        raise ValueError(f"{what} supports the SatMAE restorer, not {type(model).__name__}: "
                         f"serve it through the model's own forward")
    if getattr(model, "channel_groups", None) is not None:
        raise ValueError(f"{what} does not support the group-channel encoder "
                         f"(channel_groups): the graphs rebuild the one-embed encoder "
                         f"and its fold; serve it through the model's own forward")
    if model.decoder_arch not in ("unet_light", "unet_skip"):
        raise ValueError(f"{what} supports unet_light/unet_skip, got {model.decoder_arch}")
    if model.decoder.head_norm.kind != "batch":
        raise ValueError(f"{what} supports norm='batch', got "
                         f"{model.decoder.head_norm.kind}")
    if getattr(model, "input_fill", False):
        # The graphs have no detect/fill/conditioning prologue: without
        # this gate they would silently drop the fill stage.
        raise ValueError(f"{what} does not support input_fill models: serve them "
                         f"through the model's own forward")


def _state(model: nn.Module, variables: Optional[Tensors]) -> Tensors:
    """Parameters and buffers by name, detached: the caller's, else the
    module's. A fold is inference-only and carries no autograd graph."""
    if variables is None:
        variables = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return {k: v.detach() for k, v in variables.items()}


def _fold_bn(kernel: torch.Tensor, bias: Optional[torch.Tensor], sd: Tensors,
             norm: str, out_dim: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm ``norm`` into the preceding conv, in fp32:

        y = BN(conv(x) + b0) = conv(x) * a + (b0 * a + beta - mean * a)

    with ``a = scale / sqrt(var + eps)``; ``out_dim`` is the kernel's
    output-channel axis."""
    a = sd[f"{norm}.weight"].float() * torch.rsqrt(sd[f"{norm}.running_var"].float() + BN_EPS)
    shape = [1] * kernel.dim()
    shape[out_dim] = -1
    k = kernel.float() * a.view(shape)
    b0 = bias.float() if bias is not None else 0.0
    return k, b0 * a + sd[f"{norm}.bias"].float() - sd[f"{norm}.running_mean"].float() * a


def _channels_last(k: torch.Tensor) -> torch.Tensor:
    return k.contiguous(memory_format=torch.channels_last)


def fold_decoder(model: nn.Module, variables: Optional[Tensors] = None,
                 dtype: Optional[torch.dtype] = None, upsample: str = "ct") -> dict:
    """The folded decoder tree from live weights: BN folded into every conv
    in fp32, then cast once to ``dtype`` (default: the model's). Plain
    tensor ops on whatever device the weights are on, so it serves the
    one-shot serving fold and the per-call fold of the validation pass
    alike (the JAX package needs a numpy and a traceable twin).

    ``variables`` None reads the module's own parameters and buffers; a
    dict (as ``TrainState.eval_variables`` gives) reads those. ``upsample``
    selects the upsample weights the tree carries: ``matmul`` (``up_w``,
    ``up_b``), ``ct`` (``up_ct``, ``up_ct_b``) or ``both``.
    """
    if upsample not in ("matmul", "ct", "both"):
        raise ValueError(f"upsample must be matmul|ct|both, got {upsample!r}")
    _refuse_unsupported(model, "the folded decoder")
    sd = _state(model, variables)
    dtype = dtype or model.dtype
    dec = model.decoder

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype)

    fp: dict = {"stages": []}
    for s, up in enumerate(dec.up):
        if not isinstance(up.conv, nn.ConvTranspose2d):
            raise ValueError("the folded decoder supports ConvTranspose upsampling, "
                             "not pixel shuffle")
        # torch's ConvTranspose2d weight [Cin, Cout, 2, 2] is already the
        # un-flipped kernel: out[2i+di, 2j+dj, co] = sum_ci x[i,j,ci] W[ci,co,di,dj]
        # (the weight converter flipped the flax kernel once; no flip here).
        wk, wb = _fold_bn(sd[f"decoder.up.{s}.conv.weight"], sd[f"decoder.up.{s}.conv.bias"],
                          sd, f"decoder.up.{s}.norm", out_dim=1)
        cin, cout, kh, kw = wk.shape
        stage: dict = {"res": []}
        if upsample in ("matmul", "both"):
            # columns ordered (di, dj, co); the bias tiled over the 4 positions
            stage["up_w"] = cast(wk.permute(0, 2, 3, 1).reshape(cin, kh * kw * cout))
            stage["up_b"] = cast(wb.repeat(kh * kw))
        if upsample in ("ct", "both"):
            stage["up_ct"] = cast(wk)
            stage["up_ct_b"] = cast(wb)
        if hasattr(dec, "fuse"):
            # unet_skip: concat(skip) -> 1x1 fuse conv -> BN -> GELU; a 1x1
            # conv is a matmul on the channel axis
            fk, fb = _fold_bn(sd[f"decoder.fuse.{s}.weight"], None, sd,
                              f"decoder.fuse_norm.{s}")
            stage["fuse_w"] = cast(fk.reshape(fk.shape[0], fk.shape[1]).t())
            stage["fuse_b"] = cast(fb)
        for r in range(len(dec.res[s])):
            name = f"decoder.res.{s}.{r}"
            k1, b1 = _fold_bn(sd[f"{name}.conv0.weight"], None, sd, f"{name}.norm0")
            k2, b2 = _fold_bn(sd[f"{name}.conv1.weight"], None, sd, f"{name}.norm1")
            stage["res"].append({"k1": _channels_last(cast(k1)), "b1": cast(b1),
                                 "k2": _channels_last(cast(k2)), "b2": cast(b2)})
        fp["stages"].append(stage)

    hk, hb = _fold_bn(sd["decoder.head_conv.weight"], sd["decoder.head_conv.bias"], sd,
                      "decoder.head_norm")
    fp["head_k"] = _channels_last(cast(hk))
    fp["head_b"] = cast(hb)
    ok = sd["decoder.head_out.weight"].float()
    fp["out_k"] = cast(ok.reshape(ok.shape[0], ok.shape[1]).t())        # [Cin, Cout]
    fp["out_b"] = cast(sd["decoder.head_out.bias"].float())

    if model.decoder_arch == "unet_skip":
        # InputPyramid: level 0 is the stride-1 stem conv, levels 1.. the
        # stride-2 downsamplers; strides are implied by position.
        k, b = _fold_bn(sd["skip_stem.stem.weight"], None, sd, "skip_stem.stem_norm")
        levels = [{"k": _channels_last(cast(k)), "b": cast(b)}]
        for i in range(len(model.skip_stem.down)):
            k, b = _fold_bn(sd[f"skip_stem.down.{i}.weight"], None, sd,
                            f"skip_stem.down_norm.{i}")
            levels.append({"k": _channels_last(cast(k)), "b": cast(b)})
        fp["stem"] = levels
    return fp


def optimize_for_inference(model: nn.Module, dtype: Optional[torch.dtype] = None,
                           upsample: str = "both",
                           variables: Optional[Tensors] = None) -> dict:
    """Rewrite the model's weights into the fastpath tree that
    :func:`fast_forward` consumes: the fused-QKV encoder and the folded
    decoder of :func:`fold_decoder`, computed in fp32 and cast once to
    ``dtype`` (default: the model's). Raises ``ValueError`` for unsupported
    configurations; callers fall back to the model's own forward.
    """
    fp = fold_decoder(model, variables, dtype, upsample)
    sd = _state(model, variables)
    dtype = dtype or model.dtype
    enc = model.encoder
    d = model.embed_dim

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.float().to(dtype)

    # Conv2d weight [D, C, p, p] -> rows in (py, px, c) order, as the patches
    # are flattened.
    fp["patch_w"] = cast(sd["encoder.patch_embed.proj.weight"].permute(2, 3, 1, 0)
                         .reshape(-1, d))
    fp["patch_b"] = cast(sd["encoder.patch_embed.proj.bias"])
    fp["patch_ln"] = [cast(sd["encoder.patch_embed.norm.weight"]),
                      cast(sd["encoder.patch_embed.norm.bias"])]
    fp["pos_embed"] = cast(sd["encoder.pos_embed"])
    blocks = []
    for i, blk in enumerate(enc.blocks):
        name = f"encoder.blocks.{i}"
        scale = 1.0 / math.sqrt(d // blk.attn.num_heads)
        # nn.Linear weights are [out, in]: transpose to [in, out]
        wq = sd[f"{name}.attn.query.weight"].float().t() * scale
        bq = sd[f"{name}.attn.query.bias"].float() * scale
        wk, wv = (sd[f"{name}.attn.{p}.weight"].float().t() for p in ("key", "value"))
        bk, bv = (sd[f"{name}.attn.{p}.bias"].float() for p in ("key", "value"))
        blocks.append({
            "ln1": [cast(sd[f"{name}.norm1.weight"]), cast(sd[f"{name}.norm1.bias"])],
            "wqkv": cast(torch.cat([wq, wk, wv], dim=1)),          # [D, 3D]
            "bqkv": cast(torch.cat([bq, bk, bv])),
            "wout": cast(sd[f"{name}.attn.out.weight"].t()),
            "bout": cast(sd[f"{name}.attn.out.bias"]),
            "ln2": [cast(sd[f"{name}.norm2.weight"]), cast(sd[f"{name}.norm2.bias"])],
            "w1": cast(sd[f"{name}.mlp.fc1.weight"].t()),
            "b1": cast(sd[f"{name}.mlp.fc1.bias"]),
            "w2": cast(sd[f"{name}.mlp.fc2.weight"].t()),
            "b2": cast(sd[f"{name}.mlp.fc2.bias"]),
        })
    fp["blocks"] = blocks
    fp["final_ln"] = [cast(sd["encoder.norm.weight"]), cast(sd["encoder.norm.bias"])]
    return fp


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm with fp32 statistics, back to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _conv3(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3x3 conv with XLA's SAME padding (stride 2 pads (0, 1)); the bias is
    added in the compute dtype."""
    if stride == 1:
        y = F.conv2d(x, k.to(x.dtype), padding=1)
    else:
        y = F.conv2d(same_pad(x, 3, stride), k.to(x.dtype), stride=stride)
    return y + b.to(x.dtype)[:, None, None]


def _channel_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv as a matmul on the channel axis of a channels-last NCHW
    tensor."""
    y = x.permute(0, 2, 3, 1) @ w.to(x.dtype) + b.to(x.dtype)
    return y.permute(0, 3, 1, 2)


def _stem_features(stem: list, x: torch.Tensor) -> list:
    """The folded InputPyramid on an NCHW tile: multi-scale features,
    coarse -> fine to match the decoder stages."""
    feats = []
    y = x
    for i, lvl in enumerate(stem):
        y = gelu(_conv3(y, lvl["k"], lvl["b"], stride=1 if i == 0 else 2))
        feats.append(y)
    return feats[::-1]


def _fast_decode(fast_params: dict, y: torch.Tensor, *, matmul_upsample: bool,
                 skips: Optional[list] = None) -> torch.Tensor:
    """Folded-BN decoder on an NCHW (channels-last) token grid, shared by
    ``fast_forward`` and the hybrid graphs; returns fp32 NCHW. ``skips``
    (unet_skip only) are the coarse -> fine features of
    :func:`_stem_features`."""
    for stage_idx, stage in enumerate(fast_params["stages"]):
        bb, _, hh, ww = y.shape
        if matmul_upsample:
            cout = stage["up_w"].shape[1] // 4
            up = y.permute(0, 2, 3, 1).reshape(bb * hh * ww, -1) @ stage["up_w"].to(y.dtype)
            up = up + stage["up_b"].to(y.dtype)
            # depth-to-space of the (di, dj, co) columns
            up = up.reshape(bb, hh, ww, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
            up = up.reshape(bb, hh * 2, ww * 2, cout).permute(0, 3, 1, 2)
        else:
            up = F.conv_transpose2d(y, stage["up_ct"].to(y.dtype), stride=2)
            up = up + stage["up_ct_b"].to(y.dtype)[:, None, None]
        y = gelu(up)
        if "fuse_w" in stage:
            y = torch.cat([y, skips[stage_idx].to(y.dtype)], dim=1)
            y = gelu(_channel_matmul(y, stage["fuse_w"], stage["fuse_b"]))
        for res in stage["res"]:
            z = gelu(_conv3(y, res["k1"], res["b1"]))
            z = _conv3(z, res["k2"], res["b2"])
            y = gelu(y + z)
    y = gelu(_conv3(y, fast_params["head_k"], fast_params["head_b"]))
    return _channel_matmul(y, fast_params["out_k"], fast_params["out_b"]).float()


def fast_forward(fast_params: dict, x: torch.Tensor, *, patch_size: int = 16,
                 num_heads: int = 12, matmul_upsample: bool = True,
                 residual: bool = False) -> torch.Tensor:
    """Optimized inference forward: NHWC noisy batch -> restored fp32 NHWC
    batch, over the tree of :func:`optimize_for_inference`; it computes in
    the tree's dtype (fp32 with TF32 off). ``matmul_upsample`` picks the
    upsample form (the tree must carry it); ``residual`` adds the un-cast
    input at the end."""
    with exact_fp32(fast_params["patch_w"].dtype):
        return _fast_forward(fast_params, x, patch_size, num_heads, matmul_upsample,
                             residual)


def _fast_forward(fast_params: dict, x: torch.Tensor, patch_size: int, num_heads: int,
                  matmul_upsample: bool, residual: bool) -> torch.Tensor:
    p, heads = patch_size, num_heads
    d = fast_params["patch_w"].shape[-1]
    hd = d // heads
    dtype = fast_params["patch_w"].dtype
    b, h, w, c = x.shape
    gh, gw = h // p, w // p
    n = gh * gw
    x_in = x
    x = x.to(dtype)

    patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    tokens = patches.reshape(b, n, p * p * c) @ fast_params["patch_w"]
    tokens = tokens + fast_params["patch_b"]
    tokens = _layer_norm(tokens, *fast_params["patch_ln"])
    tokens = tokens + fast_params["pos_embed"].to(dtype)

    for blk in fast_params["blocks"]:
        y = _layer_norm(tokens, *blk["ln1"])
        qkv = y @ blk["wqkv"] + blk["bqkv"]                          # [B, N, 3D]
        q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2)        # [B, H, N, hd]
                   for t in qkv.split(d, dim=-1))
        # the query weights carry 1/sqrt(head_dim): no scaling here
        attn = torch.softmax((q @ k.transpose(-2, -1)).float(), dim=-1).to(dtype)
        y = (attn @ v).transpose(1, 2).reshape(b, n, d)
        tokens = tokens + (y @ blk["wout"] + blk["bout"])
        y = _layer_norm(tokens, *blk["ln2"])
        y = gelu(y @ blk["w1"] + blk["b1"])
        tokens = tokens + (y @ blk["w2"] + blk["b2"])

    tokens = _layer_norm(tokens, *fast_params["final_ln"])
    y = tokens.reshape(b, gh, gw, d).permute(0, 3, 1, 2)
    skips = (_stem_features(fast_params["stem"], x.permute(0, 3, 1, 2))
             if "stem" in fast_params else None)
    y = _fast_decode(fast_params, y, matmul_upsample=matmul_upsample, skips=skips)
    y = y.permute(0, 2, 3, 1)
    if residual:
        y = y + x_in.to(y.dtype)
    return y


def make_fast_inference_fn(model: nn.Module, matmul_upsample: bool = True) -> Callable:
    """``(fast_params, x) -> y`` with the model's static config bound."""
    return functools.partial(
        fast_forward, patch_size=model.patch_size,
        num_heads=model.encoder.blocks[0].attn.num_heads,
        matmul_upsample=matmul_upsample,
        residual=getattr(model, "residual_output", False))


def _hybrid(model: nn.Module, enc: Optional[Tensors], dec: dict,
            x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The module's encoder (with ``enc`` as its weights, None: its own)
    and the folded conv-transpose decoder ``dec`` on an NHWC batch, in
    ``dtype`` (fp32 with TF32 off)."""
    with exact_fp32(dtype):
        return _hybrid_graph(model, enc, dec, x, dtype)


def _hybrid_graph(model: nn.Module, enc: Optional[Tensors], dec: dict,
                  x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b = x.shape[0]
    x_in = x
    xc = x.to(dtype).contiguous().permute(0, 3, 1, 2)
    tokens = model.encoder(xc) if enc is None else functional_call(model.encoder, enc, (xc,))
    grid = model.image_size // model.patch_size
    y = tokens.reshape(b, grid, grid, model.embed_dim).permute(0, 3, 1, 2)
    skips = _stem_features(dec["stem"], xc) if "stem" in dec else None
    y = _fast_decode(dec, y, matmul_upsample=False, skips=skips).permute(0, 2, 3, 1)
    if getattr(model, "residual_output", False):
        y = y + x_in.to(y.dtype)
    return y


def _encoder_variables(variables: Optional[Tensors]) -> Optional[dict]:
    if variables is None:
        return None
    return {k.removeprefix("encoder."): v for k, v in variables.items()
            if k.startswith("encoder.")}


def make_hybrid_forward(model: nn.Module) -> Callable:
    """``(variables, x) -> y`` hybrid forward over raw weights: the
    module's encoder and the decoder folded from them on every call
    (:func:`fold_decoder`), so live or EMA weights can be scored as they
    change. ``variables`` None means the module's own. It computes in the
    autocast dtype when autocast is on, else in the model's dtype."""
    _refuse_unsupported(model, "the hybrid forward (forward_impl='hybrid')")

    def forward(variables: Optional[Tensors], x: torch.Tensor) -> torch.Tensor:
        dtype = model.compute_dtype(x.device.type)
        dec = fold_decoder(model, variables, dtype, upsample="ct")
        return _hybrid(model, _encoder_variables(variables), dec, x, dtype)

    return forward


def optimize_for_hybrid(model: nn.Module, dtype: Optional[torch.dtype] = None,
                        variables: Optional[Tensors] = None) -> dict:
    """Weights for :func:`make_hybrid_inference_fn`: ``{"enc": the encoder's
    weights as they are, "dec": the folded conv-transpose decoder}``.
    ``variables`` None folds the module's own weights, and ``enc`` is then
    None: the graph calls the module's encoder as it is, without swapping
    ~150 tensors into it on every call."""
    _refuse_unsupported(model, "the hybrid graph")
    enc = None if variables is None else _encoder_variables(_state(model, variables))
    return {"enc": enc, "dec": fold_decoder(model, variables, dtype, upsample="ct")}


def make_hybrid_inference_fn(model: nn.Module) -> Callable:
    """Large-batch inference: the module's encoder and the folded-BN
    conv-transpose decoder. Returns ``fn(weights, x)`` with ``weights``
    from :func:`optimize_for_hybrid`."""
    def infer(weights: dict, x: torch.Tensor) -> torch.Tensor:
        return _hybrid(model, weights["enc"], weights["dec"], x,
                       weights["dec"]["head_b"].dtype)

    return infer
