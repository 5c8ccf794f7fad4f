"""Inference predictors + CLI.

Port of ``llm/predict/predictor.py`` (reference
``llm/predict/predictor.py``: ``PredictorArgument`` :54, the predictor ladder
:232-1023, ``create_predictor`` :1163, ``benchmark()`` :1687). Two
predictors, as in the JAX package:

- ``EagerPredictor``  — the model's ``generate`` over left-padded batches
  (the dense forward; no kernel serves it, as in the JAX package);
- ``BlockPredictor``  — the paged continuous-batching ``InferenceEngine``
  (the paged attention kernels): ``cachekv_int8_type`` picks the int8 or
  fp8 KV pool, ``speculate_method`` the n-gram or draft-model proposer,
  ``weight_quantize_algo`` wraps the model in ``QuantizedModel``,
  ``lora_path`` merges an adapter (``merge_and_unload``).

``mesh_shape`` and ``disagg_stages`` raise ``NotImplementedError`` naming
ROADMAP Queue 1 item 12b. The model runs on ``device`` (default ``"cuda"``)
unless one is passed in. Launch on the card with

    python -m paddlenlp_tpu_torch.llm.predict.predictor --model_name_or_path <dir> --mode block
"""

from __future__ import annotations

import json
import queue
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ...trainer import PdArgumentParser
from ...transformers import AutoModelForCausalLM, AutoTokenizer
from ...utils.log import logger

__all__ = ["BasePredictor", "BlockPredictor", "EagerPredictor", "PredictorArgument", "benchmark", "create_predictor",
           "main"]

MULTI_GPU_LEFT = "ROADMAP Queue 1 item 12b"


@dataclass
class PredictorArgument:
    model_name_or_path: str = "facebook/llama-7b"
    dtype: str = "bfloat16"
    mode: str = field(default="block", metadata={"help": "eager | block (paged continuous batching)"})
    src_length: int = 1024
    max_length: int = 256
    batch_size: int = 4
    top_k: int = 0
    top_p: float = 0.7
    temperature: float = 0.95
    decode_strategy: str = field(default="sampling", metadata={"help": "sampling | greedy_search"})
    block_size: int = 16
    num_kv_blocks: int = 1024
    max_blocks_per_seq: int = 128
    cachekv_int8_type: Optional[str] = field(
        default=None,
        metadata={"help": "quantize the paged KV cache: 'dynamic' (int8) or 'fp8' "
                          "(reference predictor.py:775-791 cachekv_int8 knob)"})
    speculate_method: Optional[str] = field(
        default=None,
        metadata={"help": "speculative decoding: 'ngram' (prompt-lookup drafts, greedy "
                          "only) or 'draft_model' (small-model proposer; greedy OR plain "
                          "temperature sampling via rejection-sampling acceptance)"})
    speculate_max_draft_tokens: int = 4
    draft_model_name_or_path: Optional[str] = field(
        default=None, metadata={"help": "checkpoint for the draft model (speculate_method=draft_model)"})
    enable_prefix_cache: bool = field(
        default=True,
        metadata={"help": "share KV blocks across requests with a common prompt prefix "
                          "(refcounted blocks + copy-on-write; prefill runs only on the "
                          "uncached suffix). Disable to force full prefill per request."})
    prefill_chunk_tokens: Optional[int] = field(
        default=None,
        metadata={"help": "split prompt processing into chunks of at most this many "
                          "tokens, interleaved with decode tokens in ragged mixed "
                          "engine steps. None/0 = monolithic prefill."})
    mesh_shape: Optional[str] = field(
        default=None,
        metadata={"help": "shard the serving forward + KV pool over a device mesh: "
                          "'R,C' (dp x tp) or a bare tp degree 'T' (not part of the port "
                          "yet: ROADMAP Queue 1 item 12b). None = single device."})
    disagg_stages: Optional[str] = field(
        default=None,
        metadata={"help": "disaggregated prefill/decode serving: 'P,D' device counts "
                          "(not part of the port yet: ROADMAP Queue 1 item 12b). "
                          "None = single-stage."})
    data_file: Optional[str] = None
    output_file: Optional[str] = None
    benchmark: bool = False
    apply_chat_template: bool = False
    lora_path: Optional[str] = None
    weight_quantize_algo: Optional[str] = field(
        default=None,
        metadata={"help": "weight-only serving quantization: wint8 | wint4 | fp8 "
                          "(fp8 = float8_e4m3fn weights + per-channel scales)"})


class BasePredictor:
    def __init__(self, args: PredictorArgument, model=None, tokenizer=None, device="cuda"):
        self.args = args
        self.tokenizer = tokenizer or AutoTokenizer.from_pretrained(args.model_name_or_path)
        self.tokenizer.padding_side = "left"
        if model is None:
            model = AutoModelForCausalLM.from_pretrained(
                args.model_name_or_path, dtype=args.dtype, param_dtype=args.dtype, device=device
            )
            if args.lora_path:
                from ...peft import LoRAModel

                model = LoRAModel.from_pretrained(model, args.lora_path).merge_and_unload()
        if args.weight_quantize_algo:
            from ...quantization import QuantizationConfig, QuantizedModel

            model = QuantizedModel(
                model, QuantizationConfig(weight_quantize_algo=args.weight_quantize_algo))
        self.model = model

    def _preprocess(self, texts: List[str]):
        if self.args.apply_chat_template and self.tokenizer.chat_template:
            texts = [
                self.tokenizer.apply_chat_template([{"role": "user", "content": t}]) for t in texts
            ]
        enc = self.tokenizer(texts, padding=True, truncation=True, max_length=self.args.src_length,
                             padding_side="left", return_tensors="np")
        return enc

    def _postprocess(self, token_lists: List[List[int]]) -> List[str]:
        return [self.tokenizer.decode(t, skip_special_tokens=True) for t in token_lists]


class EagerPredictor(BasePredictor):
    """reference DygraphPredictor (:232): plain model.generate."""

    def predict(self, texts: List[str]) -> List[str]:
        enc = self._preprocess(texts)
        device = self.model.device
        out, _ = self.model.generate(
            torch.as_tensor(enc["input_ids"], device=device),
            attention_mask=torch.as_tensor(enc["attention_mask"], device=device),
            max_new_tokens=self.args.max_length,
            do_sample=self.args.decode_strategy == "sampling",
            top_p=self.args.top_p,
            top_k=self.args.top_k,
            temperature=self.args.temperature,
        )
        return self._postprocess([np.asarray(o) for o in out.cpu()])


class BlockPredictor(BasePredictor):
    """reference Dygraph/StaticBlockInferencePredictor (:953/:1023): paged engine."""

    def __init__(self, args: PredictorArgument, model=None, tokenizer=None, device="cuda"):
        mesh_shape = self._parse_mesh_shape(args.mesh_shape)
        disagg_stages = self._parse_disagg_stages(args.disagg_stages)
        if mesh_shape is not None or disagg_stages is not None:
            raise NotImplementedError(f"mesh_shape={args.mesh_shape!r}, disagg_stages={args.disagg_stages!r}: "
                                      f"multi-GPU serving is not part of the port yet ({MULTI_GPU_LEFT})")
        super().__init__(args, model, tokenizer, device)
        from ...experimental import InferenceEngine, SamplingParams

        if args.speculate_method not in (None, "ngram", "draft_model"):
            raise ValueError(f"speculate_method={args.speculate_method!r} unsupported "
                             "(pick 'ngram' or 'draft_model')")
        if args.speculate_method == "draft_model" and args.decode_strategy == "sampling" \
                and (args.top_p < 1.0 or args.top_k):
            logger.warning(
                "speculate_method=draft_model with top_p<1.0/top_k>0: rejection-sampling "
                "acceptance only covers PLAIN temperature sampling, so speculation will "
                "be bypassed at runtime. Set --top_p 1.0 --top_k 0 (or greedy_search) "
                "to actually engage the draft model.")
        draft_model = None
        if args.speculate_method == "draft_model":
            if not args.draft_model_name_or_path:
                raise ValueError("speculate_method=draft_model needs --draft_model_name_or_path")
            draft_model = AutoModelForCausalLM.from_pretrained(args.draft_model_name_or_path, dtype=args.dtype,
                                                               param_dtype=args.dtype, device=self.model.device)
        self.engine = InferenceEngine(
            self.model,
            tokenizer=self.tokenizer,
            max_batch_size=args.batch_size,
            block_size=args.block_size,
            num_blocks=args.num_kv_blocks,
            max_blocks_per_seq=args.max_blocks_per_seq,
            dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
            kv_cache_quant=self._kv_quant(args.cachekv_int8_type),
            enable_prefix_cache=args.enable_prefix_cache,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            use_speculative=args.speculate_method == "ngram",
            spec_draft_len=args.speculate_max_draft_tokens,
            draft_model=draft_model,
        )
        self._sampling = SamplingParams(
            max_new_tokens=args.max_length,
            do_sample=args.decode_strategy == "sampling",
            top_p=args.top_p,
            top_k=args.top_k,
            temperature=args.temperature,
        )

    @staticmethod
    def _parse_mesh_shape(raw: Optional[str]):
        """'R,C' -> (dp, tp); bare 'T' -> (1, T); None stays single-device."""
        if not raw:
            return None
        parts = [int(x) for x in str(raw).split(",")]
        if len(parts) == 1:
            parts = [1, parts[0]]
        if len(parts) != 2 or any(p < 1 for p in parts):
            raise ValueError(
                f"--mesh_shape must be 'T' or 'R,C' with positive degrees, got {raw!r}")
        return tuple(parts)

    @staticmethod
    def _parse_disagg_stages(raw: Optional[str]):
        """'P,D' -> (prefill_devices, decode_devices); None stays single-stage."""
        if not raw:
            return None
        parts = [int(x) for x in str(raw).split(",")]
        if len(parts) != 2 or any(p < 1 for p in parts):
            raise ValueError(
                f"--disagg_stages must be 'P,D' with positive device counts, got {raw!r}")
        return tuple(parts)

    @staticmethod
    def _kv_quant(cachekv_int8_type):
        if cachekv_int8_type is None:
            return None
        mapping = {"dynamic": "int8", "int8": "int8", "fp8": "fp8"}
        if cachekv_int8_type not in mapping:
            raise ValueError(
                f"cachekv_int8_type={cachekv_int8_type!r} unsupported; pick from "
                f"{sorted(mapping)} (the reference's 'static' calibrated scales are "
                "not implemented — dynamic per-token scales quantize at write time)")
        return mapping[cachekv_int8_type]

    def predict(self, texts: List[str]) -> List[str]:
        prompts = [self.tokenizer.encode(t)[-self.args.src_length:] for t in texts]
        outs = self.engine.generate(prompts, self._sampling)
        return self._postprocess(outs)

    def stream_predict(self, text: str):
        """Yield decoded text pieces as tokens land (serving path)."""
        q: "queue.Queue" = queue.Queue()
        prompt = self.tokenizer.encode(text)[-self.args.src_length:]
        self.engine.add_request(prompt, self._sampling, stream_cb=lambda tok, done: q.put((tok, done)))
        toks: List[int] = []
        emitted = 0
        while True:
            while self.engine.has_work() and q.empty():
                self.engine.step()
            tok, done = q.get()
            toks.append(tok)
            text_so_far = self.tokenizer.decode(toks, skip_special_tokens=True)
            if len(text_so_far) > emitted:
                yield text_so_far[emitted:]
                emitted = len(text_so_far)
            if done:
                break


def create_predictor(args: PredictorArgument, model=None, tokenizer=None, device="cuda") -> BasePredictor:
    """reference create_predictor (:1163). ``device`` places a model loaded
    from ``args.model_name_or_path``; a ``model`` passed in stays where it is."""
    if args.mode == "eager":
        return EagerPredictor(args, model, tokenizer, device)
    if args.mode == "block":
        return BlockPredictor(args, model, tokenizer, device)
    raise ValueError(f"unknown predictor mode {args.mode!r} (eager|block)")


def benchmark(predictor: BasePredictor, texts: List[str], warmup: int = 1, iters: int = 3):
    """reference benchmark (:1687): tokens/sec + latency stats (wall clock:
    each ``predict`` returns host lists, after the device finished)."""
    for _ in range(warmup):
        predictor.predict(texts[: predictor.args.batch_size])
    t0 = time.time()
    n_tokens = 0
    for _ in range(iters):
        outs = predictor.predict(texts[: predictor.args.batch_size])
        n_tokens += sum(len(predictor.tokenizer.encode(o)) for o in outs)
    dt = time.time() - t0
    stats = {"output_tokens_per_second": round(n_tokens / dt, 2), "latency_s": round(dt / iters, 3)}
    logger.info(f"benchmark: {stats}")
    return stats


def main(argv: Optional[List[str]] = None, device="cuda"):
    parser = PdArgumentParser((PredictorArgument,))
    (args,) = parser.parse_args_into_dataclasses(argv)
    predictor = create_predictor(args, device=device)
    if args.data_file:
        with open(args.data_file) as f:
            texts = [json.loads(line).get("src", "") for line in f if line.strip()]
    else:
        texts = ["hello"]
    if args.benchmark:
        benchmark(predictor, texts)
        return
    outputs = []
    bs = args.batch_size
    for i in range(0, len(texts), bs):
        outputs.extend(predictor.predict(texts[i : i + bs]))
    if args.output_file:
        with open(args.output_file, "w") as f:
            for src, out in zip(texts, outputs):
                f.write(json.dumps({"src": src, "output": out}, ensure_ascii=False) + "\n")
    else:
        for src, out in zip(texts, outputs):
            print(json.dumps({"src": src, "output": out}, ensure_ascii=False))


if __name__ == "__main__":
    main()
