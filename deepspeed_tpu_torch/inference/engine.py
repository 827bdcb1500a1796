"""Inference engine (port of ``deepspeed_tpu/inference/engine.py``).

``generate`` follows the JAX engine step for step: prompt-length buckets
(right padding, the true length carried to the first-token pick), batch
buckets (rows padded with row 0 and dropped), a per-request sampling stream
derived from the engine seed, the request count and the prompt length,
``temperature == 0`` as greedy, and an early stop once every row has
emitted ``eos_token_id``. Prefill and decode run eagerly on the engine's
device; the weights live on the model (``engine.params``) in the serving
dtype. With ``quant.enabled`` the block matmul kernels are then quantized
to int8 or int4 (``_quantize_weights``) and every block linear runs the
dequant-matmul kernel.

``serve`` streams requests through the continuous-batching slot pool of
``serving/engine.py`` (the ``serving`` config block), built lazily on first
use over the same weights.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``load_checkpoint`` (A.5), tensor parallelism (A.7) and the static
program audits (A.9).
"""

import time

import numpy as np
import torch

from ..accelerator import get_accelerator
from ..config.base import ConfigError
from ..models.layers import flatten_tree, unflatten_tree
from ..utils import not_ported
from ..utils.logging import log_dist

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _request_seed(seed, request_seq, prompt_len):
    """The sampling seed of one request: the engine seed with the request
    count and the prompt length folded in (the JAX engine folds the same
    two into its key), so two identical requests never share a stream."""
    return int(np.random.SeedSequence([seed, request_seq, prompt_len]).generate_state(1)[0])


class InferenceEngine:
    def __init__(self, model, config, device=None, model_parameters=None):
        if model is None:
            raise ConfigError("init_inference: model is required")
        self.device = get_accelerator().resolve_device(device)
        self.module = model
        self._config = config
        self.dtype = DTYPES[config.dtype]
        if hasattr(model, "config") and hasattr(model.config, "compute_dtype"):
            model.config.compute_dtype = self.dtype
        self.mp_world_size = 1
        self._request_seq = 0  # folded into per-request sampling seeds
        self.last_timing = None
        self._serving = None
        self._init_parameters(model_parameters)
        if config.quant.enabled:
            self._quantize_weights()
        log_dist(f"InferenceEngine: device={self.device} dtype={config.dtype} "
                 f"max_tokens={config.max_tokens}", ranks=[0])

    # ------------------------------------------------------------------------------
    def _init_parameters(self, model_parameters):
        if model_parameters is None:
            # drawn directly in the serving dtype on the device: a 7B model
            # never has an fp32 copy on the host
            gen = torch.Generator(device=self.device).manual_seed(self._config.seed)
            with torch.no_grad():
                params = self.module.init(gen, dtype=self.dtype, device=self.device)
            self.module.load_params(params)
        else:
            self.params = model_parameters

    @property
    def params(self):
        return self.module.params

    @params.setter
    def params(self, values):
        """Accepts the port's tree of tensors or a JAX params tree of numpy
        arrays; either is cast to the serving dtype on the engine's device,
        apart from quantized payloads and their scales (``stored_dtype``).
        A float tree set on a ``quant`` engine is not quantized again until
        ``_quantize_weights`` runs, as in the JAX engine."""
        from ..interop.jax_params import from_jax, stored_dtype

        flat = flatten_tree(values)
        if all(isinstance(v, torch.Tensor) for v in flat.values()):
            values = unflatten_tree({
                path: v.detach().to(self.device, stored_dtype(path, v, self.dtype))
                for path, v in flat.items()})
        else:
            values = from_jax(values, self.module, dtype=self.dtype, device=self.device)
        self.module.load_params(values)

    @torch.no_grad()
    def _quantize_weights(self):
        """Weight-only int8/int4 serving (the JAX engine's
        ``_quantize_weights``): every block matmul ``kernel`` of ndim >= 2
        (stacked [L, in, out]) outside ``router`` subtrees becomes
        ``kernel_q`` (int8) or, for bits 4 and an even in-dim, the nibble-
        packed ``kernel_q4`` (uint8 [L, in/2, out]), beside ``kernel_scale``
        (fp32 [L, groups, 1, out]). Embeddings, norms and the head stay in
        the serving dtype. Quantized on the engine's device from the serving-
        dtype weights, one layer at a time, and each float kernel is dropped
        as soon as its quantized form exists: the peak is the serving-dtype
        model plus one quantized kernel."""
        from ..ops.quantizer import pack_int4, quantize_per_channel

        bits = self._config.quant.bits
        group_size = self._config.quant.group_size
        blocks = self.module._modules.get("blocks")
        if blocks is None:
            raise ConfigError(
                "quant.enabled needs a zoo-style model (params with a "
                "'blocks' subtree whose matmuls read quantized kernels); an "
                "injection-policy-served unknown model must be served "
                "unquantized")
        counts = {"packed": 0, "int8": 0}

        def quantize(w):
            # layer by layer: layer-sized fp32 temporaries, the same values
            lead = w.shape[:-2]
            w2 = w.reshape(-1, *w.shape[-2:])
            q0, s0 = quantize_per_channel(w2[0], bits=bits, group_size=group_size)
            packed = bits == 4 and w.shape[-2] % 2 == 0
            if packed:
                q0 = pack_int4(q0)
            q = torch.empty((w2.shape[0], *q0.shape), dtype=q0.dtype, device=w.device)
            scale = torch.empty((w2.shape[0], *s0.shape), dtype=s0.dtype, device=w.device)
            q[0], scale[0] = q0, s0
            for i in range(1, w2.shape[0]):
                qi, scale[i] = quantize_per_channel(w2[i], bits=bits, group_size=group_size)
                q[i] = pack_int4(qi) if packed else qi
            return (q.reshape(*lead, *q0.shape), scale.reshape(*lead, *s0.shape), packed)

        def walk(node, name):
            if "router" in name:
                return  # MoE routers stay in the serving dtype (stable gating)
            kernel = node._parameters.get("kernel")
            if kernel is not None and kernel.dim() >= 2:
                q, scale, packed = quantize(kernel)
                del node._parameters["kernel"]
                node.register_parameter("kernel_q4" if packed else "kernel_q",
                                        torch.nn.Parameter(q, requires_grad=False))
                node.register_parameter("kernel_scale",
                                        torch.nn.Parameter(scale, requires_grad=False))
                counts["packed" if packed else "int8"] += 1
                return
            for key, child in node._modules.items():
                walk(child, f"{name}/{key}")

        walk(blocks, "blocks")
        packed_note = f", {counts['packed']} nibble-packed" if counts["packed"] else ""
        fallback_note = f", {counts['int8']} int8-stored" \
            if bits == 4 and counts["int8"] else ""
        log_dist(f"int{bits} weight-only quantization applied to "
                 f"{sum(counts.values())} block kernels "
                 f"(group_size={group_size}{packed_note}{fallback_note})", ranks=[0])

    def load_checkpoint(self, load_dir, tag=None):
        raise not_ported("InferenceEngine.load_checkpoint", "A.5")

    # ------------------------------------------------------------------------------
    def _as_ids(self, input_ids):
        if isinstance(input_ids, torch.Tensor):
            return input_ids.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(input_ids), dtype=torch.int64, device=self.device)

    @torch.inference_mode()
    def forward(self, input_ids):
        """Full-sequence logits (no cache) — the scoring path. Causal models
        bucket the sequence dim (right padding cannot reach earlier positions
        under a causal mask); the pad columns are sliced off."""
        input_ids = self._as_ids(input_ids)
        b, s = input_ids.shape
        causal = getattr(getattr(self.module, "config", None), "causal", False)
        padded = self._bucket_prompt_len(s, self._config.max_tokens) if causal else s
        if padded > s:
            input_ids = torch.nn.functional.pad(input_ids, (0, padded - s))
        logits = self.module(input_ids)
        return logits[:, :s] if padded > s else logits

    def __call__(self, input_ids):
        return self.forward(input_ids)

    def destroy(self):
        """Release the weights, the serving slot pool and the device memory
        they held."""
        if self._serving is not None:
            self._serving.destroy()
            self._serving = None
        self.module.set_tree({})
        get_accelerator().empty_cache()

    def _bucket_prompt_len(self, prompt_len, ceiling):
        return bucket_prompt_len(self._config, prompt_len, ceiling)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
                 greedy=True, eos_token_id=None, generator=None):
        """Autoregressive generation: prefill + decode loop.

        input_ids: [b, prompt_len] (uniform length). Returns a
        [b, prompt_len + max_new_tokens] int32 tensor on the engine's device.
        ``generator`` (a ``torch.Generator`` on that device) reproduces a
        sampled stream; by default each call draws from its own seed.
        ``last_timing`` holds the prefill and decode times of the call."""
        from ..models.decoding import (decode_tokens, decode_tokens_until,
                                       prefill_and_first_token)

        if not hasattr(self.module, "config"):
            raise ConfigError("generate() needs a zoo-style model")
        input_ids = self._as_ids(input_ids)
        b, prompt_len = input_ids.shape
        if prompt_len + max_new_tokens > self._config.max_tokens:
            raise ConfigError(
                f"generate: prompt {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds max_tokens {self._config.max_tokens}")
        self._request_seq += 1
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                _request_seed(self._config.seed, self._request_seq, prompt_len))
        # a concrete temperature of 0.0 IS greedy (exact argmax)
        if temperature == 0.0:
            greedy = True

        # batch bucketing: pad rows with row 0 (their outputs are dropped)
        b_real = b
        b_bucket = max(int(self._config.batch_bucket_size), 1)
        if b % b_bucket:
            padded_b = -(-b // b_bucket) * b_bucket
            input_ids = torch.cat([input_ids, input_ids[:1].expand(padded_b - b, -1)])
            b = padded_b

        # prompt-length bucketing: right-pad, sample the first token at the true length
        padded_len = self._bucket_prompt_len(prompt_len,
                                             self._config.max_tokens - max_new_tokens)
        max_len = padded_len + max_new_tokens
        ids_in = torch.nn.functional.pad(input_ids, (0, padded_len - prompt_len))

        model, params = self.module, self.params
        timer = _Timer(self.device)
        first, cache = prefill_and_first_token(
            model, params, ids_in, generator, temperature, max_len=max_len,
            greedy=greedy, top_k=top_k, dtype=self.dtype, true_len=prompt_len)
        timer.mark("prefill")
        out = [input_ids, first[:, None]]
        if max_new_tokens > 1:
            kw = dict(prompt_len=prompt_len, max_len=max_len, steps=max_new_tokens - 1,
                      greedy=greedy, top_k=top_k)
            if eos_token_id is not None:
                toks, _ = decode_tokens_until(model, params, cache, first, generator,
                                              temperature, eos_token_id=int(eos_token_id), **kw)
            else:
                toks, _ = decode_tokens(model, params, cache, first, generator,
                                        temperature, **kw)
            out.append(toks.T)
        timer.mark("decode")
        self.last_timing = timer
        result = torch.cat(out, dim=1)[:b_real]
        if eos_token_id is not None:
            result = _truncate_after_eos(result, prompt_len, eos_token_id)
        return result.to(torch.int32)

    def warmup(self, prompt_lens, max_new_tokens=32, batch_size=1, temperature=1.0,
               top_k=0, greedy=True, eos_token_id=None):
        """Run one request per prompt length, so the kernels are built and
        loaded before a live request. Returns the number of distinct prompt
        buckets served (lengths in one bucket share its shapes)."""
        rng = np.random.RandomState(0)
        buckets = set()
        for p in prompt_lens:
            ids = rng.randint(0, self.module.config.vocab_size, (batch_size, int(p)))
            self.generate(ids, max_new_tokens=max_new_tokens, temperature=temperature,
                          top_k=top_k, greedy=greedy, eos_token_id=eos_token_id)
            buckets.add(self._bucket_prompt_len(int(p), self._config.max_tokens - max_new_tokens))
        return len(buckets)

    def serve(self, requests=None, **kwargs):
        """Continuous-batching streaming serving: yields per-request
        ``TokenEvent``s as tokens are produced (``serving/engine.py``).
        Finished requests free their slot mid-flight and queued ones are
        spliced in without draining the batch. Configured by the inference
        config's ``serving`` block."""
        return self.serving.serve(requests, **kwargs)

    @property
    def serving(self):
        """The lazily built ServingEngine bound to this engine's weights."""
        if self._serving is None:
            from ..serving import ServingEngine

            self._serving = ServingEngine(self)
        return self._serving

    def decode_program_report(self, *args, **kwargs):
        raise not_ported("decode_program_report (static program audit)", "A.9")

    def prefill_chunk_report(self, *args, **kwargs):
        raise not_ported("prefill_chunk_report (static program audit)", "A.9")

    def verify_program_report(self, *args, **kwargs):
        raise not_ported("verify_program_report (static program audit)", "A.9")

    @property
    def config(self):
        return self._config


class _Timer:
    """Phase times of one generate call: CUDA events on the card (read after
    the call, nothing synchronises inside it), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = [("start", self._now())]

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, name):
        self.marks.append((name, self._now()))

    def seconds(self):
        """{phase: seconds}; waits for the card's events."""
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if self.cuda:
                b.synchronize()
                out[name] = a.elapsed_time(b) / 1e3
            else:
                out[name] = b - a
        return out


def bucket_prompt_len(config, prompt_len, ceiling):
    """Padded prompt length under ``config``'s bucket policy, clipped to
    ``ceiling`` (the KV window minus generation room). "multiple": next
    multiple of prompt_bucket_size. "pow2" (default): next
    prompt_bucket_size doubling, so at most log2(max_tokens) buckets."""
    bucket = max(int(config.prompt_bucket_size), 1)
    if bucket > 1 and config.prompt_bucket_policy == "pow2":
        padded = bucket
        while padded < prompt_len:
            padded *= 2
    else:
        padded = -(-prompt_len // bucket) * bucket
    return max(min(padded, ceiling), prompt_len)


def _truncate_after_eos(tokens, prompt_len, eos):
    """Replace everything after the first EOS (per row) with EOS."""
    gen = tokens[:, prompt_len:]
    after = torch.cumsum((gen == eos).int(), dim=1) > 0
    gen = torch.where(after, torch.full_like(gen, eos), gen)
    return torch.cat([tokens[:, :prompt_len], gen], dim=1)
