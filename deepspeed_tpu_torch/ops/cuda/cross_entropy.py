"""Streaming LM-head cross-entropy forward: the CUDA kernel's wrapper and its plain version.

``fused_ce_forward`` is the port of the Pallas TPU kernel
``pallas_ce_forward`` (``deepspeed_tpu/ops/pallas/cross_entropy.py``,
``_ce_fwd_kernel``) as the hand-written CUDA kernel
``deepspeed_tpu_torch/csrc/fused_ce_fwd.cu``: for each token, the logsumexp
and the label's logit of ``x @ emb^T (+ bias)`` over the whole vocabulary,
with the logits never stored.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes ``fused_ce_forward_reference``, the plain fp32 math over vocab
chunks, which the tests hold against the TPU kernel and ``chip_smoke.py``
holds the CUDA kernel against on the card.
"""

import torch

from . import LAUNCH_COUNTS

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check_shapes(x, emb, labels, bias):
    if x.dim() != 2 or emb.dim() != 2 or x.shape[1] != emb.shape[1]:
        raise ValueError(f"fused CE takes x [T, d] and emb [V, d]; got {tuple(x.shape)}, "
                         f"{tuple(emb.shape)}")
    if labels.shape != (x.shape[0],) or labels.is_floating_point():
        raise ValueError(f"labels {tuple(labels.shape)} {labels.dtype} are not {x.shape[0]} "
                         f"integer ids")
    if bias is not None and bias.shape != (emb.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match vocab {emb.shape[0]}")


def fused_ce_forward_reference(x, emb, labels, bias=None, block_v=4096):
    """Plain version: logits of x and emb cast to x's dtype, with fp32
    products and sums (as the kernel's fp32 accumulation), plus the fp32
    bias, folded into an online (max, sum) over vocab chunks of ``block_v``.
    Returns (lse, label_logit), fp32 [T] each."""
    _check_shapes(x, emb, labels, bias)
    xf = x.float()
    ef = emb.to(x.dtype).float()
    tokens, vocab = x.shape[0], emb.shape[0]
    m = torch.full((tokens,), NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros((tokens,), dtype=torch.float32, device=x.device)
    lab = torch.zeros((tokens,), dtype=torch.float32, device=x.device)
    labels = labels.long()
    rows = torch.arange(tokens, device=x.device)
    for c0 in range(0, vocab, block_v):
        c1 = min(c0 + block_v, vocab)
        logits = xf @ ef[c0:c1].T
        if bias is not None:
            logits = logits + bias[c0:c1].float()[None, :]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        hit = (labels >= c0) & (labels < c1)
        picked = logits[rows, (labels - c0).clamp(0, c1 - c0 - 1)]
        lab = torch.where(hit, picked, lab)
    return m + torch.log(torch.clamp(s, min=1e-30)), lab


def accumulation_bound(x, emb, lse):
    """Per-token bound on |kernel - plain| for (lse, label_logit): both sum
    the same exact (16-bit inputs) or once-rounded (fp32) products in fp32 in
    another order, at most d 2^-24 sum_k |x_k e_k| <= d 2^-24 |x| max_j |e_j|
    per logit (Cauchy-Schwarz); lse moves by at most the largest logit error,
    plus a few ulps of exp/log on |lse|."""
    d = x.shape[1]
    x_norm = x.float().norm(dim=1)
    e_norm = emb.to(x.dtype).float().norm(dim=1).max()
    return (d + 1) * 2.0 ** -24 * x_norm * e_norm + 2.0 ** -22 * lse.abs()


def _check_kernel_inputs(x, emb, labels, bias):
    for name, t in (("emb", emb), ("labels", labels), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"fused CE: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _KERNEL_DTYPES or emb.dtype != x.dtype:
        raise TypeError(f"fused CE kernel takes fp32/fp16/bf16 x and emb of one dtype; got "
                        f"{x.dtype}, {emb.dtype}")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise TypeError(f"fused CE kernel takes contiguous int32 labels, got {labels.dtype}")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        raise TypeError(f"fused CE kernel takes a contiguous fp32 bias, got {bias.dtype}")
    vec = 16 // x.element_size()
    if x.shape[1] % vec:
        raise ValueError(f"fused CE kernel needs d a multiple of {vec} for {x.dtype}, got "
                         f"{x.shape[1]}")
    for name, t in (("x", x), ("emb", emb)):
        # rows are copied 16 bytes at a time
        if t.stride(1) != 1 or t.stride(0) % vec or t.data_ptr() % 16:
            raise ValueError(f"fused CE kernel needs contiguous 16-byte aligned rows; {name} "
                             f"strides {t.stride()} at offset {t.data_ptr() % 16}")


def fused_ce_forward(x, emb, labels, bias=None):
    """(lse, label_logit), fp32 [T] each, of ``x [T, d] @ emb [V, d]^T``
    (+ fp32 ``bias [V]``). ``emb`` is cast to x's dtype first, as the TPU
    kernel does, into row-major rows; ``labels`` must already be safe (ignored rows hold any id
    in range).

    CPU tensors take ``fused_ce_forward_reference``. CUDA tensors launch the
    kernel on the current stream (labels as int32) or raise on what
    it does not take: dtypes other than fp32/fp16/bf16, d not a multiple of
    16 bytes, rows not contiguous and 16-byte aligned, tensors on other
    devices."""
    _check_shapes(x, emb, labels, bias)
    if all(t.device.type == "cpu" for t in (x, emb, labels)) and (
            bias is None or bias.device.type == "cpu"):
        return fused_ce_forward_reference(x, emb, labels, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused CE runs on CUDA or CPU tensors, got {x.device}")
    # row-major rows for the kernel's 16-byte copies (an untied head's emb is
    # the transposed view of its [d, V] kernel)
    emb = emb.to(x.dtype, memory_format=torch.contiguous_format)
    labels = labels.to(torch.int32).contiguous()
    _check_kernel_inputs(x, emb, labels, bias)
    tokens, d = x.shape
    vocab = emb.shape[0]
    lse = torch.empty((tokens,), dtype=torch.float32, device=x.device)
    lab = torch.empty((tokens,), dtype=torch.float32, device=x.device)
    if tokens == 0:
        return lse, lab
    from ..op_builder import load_op

    lib = load_op("fused_ce_forward")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ds_fused_ce_fwd(
            x.data_ptr(), emb.data_ptr(), labels.data_ptr(),
            bias.data_ptr() if bias is not None else None, lse.data_ptr(), lab.data_ptr(),
            _KERNEL_DTYPES[x.dtype], tokens, vocab, d, x.stride(0), emb.stride(0), stream)
    if err:
        raise RuntimeError(f"fused_ce_forward launch failed: cudaError_t {err}")
    LAUNCH_COUNTS["fused_ce_forward"] += 1
    return lse, lab
