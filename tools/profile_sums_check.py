"""``chip_smoke.profile_sums`` against ``torch.profiler``'s ``key_averages()``
on one CUDA card, and the seconds each takes: a synthetic workload (a
``record_function`` range, matmuls, elementwise ops), then one profiled
decode call of the engine at Qwen2-7B's widths, over the bf16 model and over
its a8w8 facade. One JSON line a profile: whether both give the same kernel
names and counts, the largest difference of a kernel's device ms, and each
named host op's device ms and count from both.

    python3 tools/profile_sums_check.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddlenlp_tpu_torch import quantization  # noqa: E402
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams  # noqa: E402
from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM  # noqa: E402

ACT = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def compare(tag, prof, names):
    t0 = time.perf_counter()
    k, ins = cs.profile_sums(torch, prof, names)
    t1 = time.perf_counter()
    avg = prof.key_averages()
    t2 = time.perf_counter()
    ref_k = {e.key: [e.self_device_time_total / 1e3, e.count] for e in avg
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    ref_in = {n: [0.0, 0] for n in names}
    for e in avg:
        if e.device_type == DeviceType.CPU and e.key in ref_in:
            ref_in[e.key] = [e.device_time_total / 1e3, e.count]
    kd = max((abs(k[n][0] - ref_k[n][0]) for n in ref_k if n in k), default=0.0)
    out = dict(tag=tag, helper_s=t1 - t0, key_averages_s=t2 - t1,
               kernel_keys_equal=set(k) == set(ref_k), only_helper=sorted(set(k) - set(ref_k))[:5],
               only_ref=sorted(set(ref_k) - set(k))[:5],
               counts_equal=all(k[n][1] == ref_k[n][1] for n in ref_k if n in k),
               kernel_ms_max_abs_diff=kd,
               total_ms=[sum(v[0] for v in k.values()), sum(v[0] for v in ref_k.values())],
               inside={n: [ins[n], ref_in[n]] for n in names})
    print(json.dumps(out), flush=True)


def main():
    dev = "cuda"
    a = torch.randn(512, 512, device=dev)
    b = torch.randn(512, 512, device=dev)

    def work():
        for _ in range(50):
            with torch.profiler.record_function("dequantize_leaf"):
                w = (b * 0.5).to(torch.bfloat16).float()
            c = a @ w
            c = torch.relu(c) + 1
        torch.cuda.synchronize()

    work()
    with profile(activities=ACT) as prof:
        work()
    compare("synthetic", prof, ("dequantize_leaf", "aten::mm", "aten::relu"))

    model = Qwen2ForCausalLM.init_random(Qwen2Config(**cs.QWEN2_7B), seed=0, device=dev, dtype=torch.bfloat16)
    prompts, _ = cs.traffic(np, model.config.vocab_size, 0)
    for tag, m in (("bf16", model), ("a8w8", None)):
        if m is None:
            m = quantization.QuantizedModel(model, quantization.QuantizationConfig(weight_quantize_algo="a8w8"))
        eng = InferenceEngine(m, **cs.SERVE_ENGINE)
        for p in prompts:
            eng.add_request(p, SamplingParams(max_new_tokens=1 + 2 * eng.decode_steps))
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=ACT) as prof:
            eng.step()
            torch.cuda.synchronize()
        print(json.dumps(dict(tag=tag, profiled_with_exit_s=time.perf_counter() - t0)), flush=True)
        compare(tag, prof, ("dequantize_leaf", "quantize_activations", "aten::mm", "aten::_int_mm", "aten::bmm",
                            "aten::index_select"))
        del eng, m
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
