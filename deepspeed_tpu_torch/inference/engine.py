"""Inference engine (port of ``deepspeed_tpu/inference/engine.py``).

``generate`` follows the JAX engine step for step: prompt-length buckets
(right padding, the true length carried to the first-token pick), batch
buckets (rows padded with row 0 and dropped), a per-request sampling stream
derived from the engine seed, the request count and the prompt length,
``temperature == 0`` as greedy, and an early stop once every row has
emitted ``eos_token_id``. Prefill and decode run eagerly on the engine's
device; the weights live on the model (``engine.params``) in the serving
dtype.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``serve``/``serving`` (A.2), ``load_checkpoint`` (A.5), tensor
parallelism (A.7) and the static program audits (A.9).
"""

import time

import numpy as np
import torch

from ..accelerator import get_accelerator
from ..config.base import ConfigError
from ..models.layers import flatten_tree, tree_map
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
        self._init_parameters(model_parameters)
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
        arrays; either is cast to the serving dtype on the engine's device."""
        if all(isinstance(v, torch.Tensor) for v in flatten_tree(values).values()):
            values = tree_map(lambda v: v.detach().to(self.device, self.dtype), values)
        else:
            from ..interop.jax_params import from_jax

            values = from_jax(values, self.module, dtype=self.dtype, device=self.device)
        self.module.load_params(values)

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
        """Release the weights and the device memory they held."""
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
        raise not_ported("continuous-batching serving (engine.serve)", "A.2")

    @property
    def serving(self):
        raise not_ported("the ServingEngine (engine.serving)", "A.2")

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
