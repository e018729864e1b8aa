"""The port's kernel-profiling tools, on the CPU at tiny sizes.

Each tool's ``main`` with ``--device cpu`` runs the kernels' plain versions
and times nothing; without a card and without ``--device cpu`` it raises;
the JAX tools' TPU knobs are refused, not ignored. ``analyze_trace`` is held
to a synthetic chrome trace whose sums are known.
"""

import gzip
import json

import pytest
import torch

from scratchpad_tpu_torch.ops.attention.decode_ablate import MODES, NEG
from scratchpad_tpu_torch.tools import (
    analyze_trace,
    decode_ablate,
    decode_kernel_bench,
    extend_stages,
    prefill_ab,
    prof_attn,
    w4_kernel_bench,
)

TINY_ABLATE = ["--device", "cpu", "--batch", "2", "--ctx", "20", "--layers", "2", "--kv-heads", "2",
               "--q-heads", "4", "--dp", "64", "--page-size", "4", "--chunk-pages", "2",
               "--table-width", "6", "--pages-per-layer", "16", "--stage-batch", "2",
               "--stage-ctx", "40"]


def test_decode_ablate_tool_runs_every_mode_and_stage_on_cpu(capsys):
    rows = decode_ablate.main(TINY_ABLATE)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"device": "cpu"} and lines[1:] == json.loads(json.dumps(rows))
    modes = [r for r in rows if r["table"] == "mode"]
    assert [r["mode"] for r in modes] == list(MODES)
    neg = float(torch.tensor(NEG).to(torch.bfloat16))
    for r in modes:
        assert r["ms"] is None and r["plain_ms"] is None and r["bound_ms"] > 0
        # a pool of zeros: m stays -1e30 until no_pv, then m = 0 and l = ctx,
        # through both chained layers
        assert r["out"] == (neg if r["mode"] in MODES[:3] else 20.0)
    stages = [(r["model"], r["stage"]) for r in rows if r["table"] == "stage"]
    assert stages == [(m, s) for m in ("1b", "3b", "7b") for s in (1, 2, 3, 4, 5)]
    assert all(r["ms"] is None for r in rows)


def test_decode_ablate_tool_checks_the_table_width():
    with pytest.raises(SystemExit, match="too narrow"):
        decode_ablate.main(TINY_ABLATE + ["--table-width", "1"])


@pytest.mark.parametrize(
    "main, argv",
    [
        (decode_ablate.main, []),
        (prof_attn.main, []),
        (decode_kernel_bench.main, []),
        (w4_kernel_bench.main, ["--shape", "a:256:128"]),
        (extend_stages.main, []),
    ],
    ids=["decode_ablate", "prof_attn", "decode_kernel_bench", "w4_kernel_bench",
         "extend_stages"],
)
def test_tools_raise_without_a_card(main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_extend_stages_on_cpu():
    rows = extend_stages.main(["--device", "cpu"])
    assert [r["shape"] for r in rows] == list(extend_stages.SHAPES)
    assert all(r["finite"] and "kernel_ms" not in r for r in rows)
    # the bound of the 1B's long chunk: operations, 2048 queries over 6,145
    # to 8,192 keys, 32 heads of 64
    ms, by = extend_stages.bound(*extend_stages.SHAPES["1b-long"])
    assert by == "operations" and ms == pytest.approx(0.121605, rel=1e-4)


def test_prefill_timer_times_extend_forwards_only(monkeypatch):
    """PrefillTimer wraps the model's forward while active: extend forwards
    are counted and timed, decode forwards pass through untouched, and the
    forward is restored on exit."""
    from types import SimpleNamespace

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode

    class Event:  # a stand-in for torch.cuda.Event: 2.5 ms a span
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def elapsed_time(self, end):
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    model = SimpleNamespace(forward=lambda meta, kv: calls.append(meta.mode) or meta.mode)
    inner = model.forward
    with prefill_ab.PrefillTimer(model) as timer:
        for mode in (ForwardMode.EXTEND, ForwardMode.DECODE, ForwardMode.EXTEND):
            assert model.forward(SimpleNamespace(mode=mode), None) == mode
    assert model.forward is inner
    assert calls == [ForwardMode.EXTEND, ForwardMode.DECODE, ForwardMode.EXTEND]
    assert timer.forwards == 2 and timer.device_ms == 5.0 and timer.wall_ms >= 0.0


def test_prof_attn_on_cpu():
    rows = prof_attn.main(["--device", "cpu", "--cases", "a=2:20", "b=3:40", "--layers", "2",
                           "--pages-per-layer", "16"])
    assert [(r["B"], r["ctx"]) for r in rows] == [(2, 20), (3, 40)]
    assert all(r["finite"] and r["ms"] is None for r in rows)
    assert rows[1]["live_MB"] == 3 * 40 * 2 * 2 * 8 * 64 * 2 / 1e6


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_decode_kernel_bench_on_cpu(kv, monkeypatch):
    monkeypatch.setenv("KB_KV", kv)
    r = decode_kernel_bench.main(["llama-3.2-1b", "20", "2", "--device", "cpu"])
    assert r["kv"] == kv and r["finite"] and r["us_per_call"] is None
    elem = 2 if kv == "bf16" else 1
    assert r["stream_MB"] == 2 * 2 * 16 * 8 * (64 * elem * 2 + (0 if kv == "bf16" else 4)) / 1e6


@pytest.mark.parametrize("knob", decode_kernel_bench.TPU_KNOBS)
def test_decode_kernel_bench_refuses_tpu_knobs(knob, monkeypatch):
    monkeypatch.setenv(knob, "1")
    with pytest.raises(SystemExit, match=knob):
        decode_kernel_bench.main(["--device", "cpu"])


@pytest.mark.parametrize("route", ["a16", "a8"])
def test_w4_kernel_bench_on_cpu(route):
    rows = w4_kernel_bench.main(["--device", "cpu", "--bs", "2", "--route", route,
                                 "--shape", "a:256:128", "--shape", "b:512:384"])
    assert [(r["name"], r["In"], r["Out"], r["route"]) for r in rows] == [
        ("a", 256, 128, route), ("b", 512, 384, route)]
    assert all(r["finite"] and r["us"] is None for r in rows)


def test_w4_kernel_bench_refuses_blocks():
    with pytest.raises(SystemExit, match="blocks"):
        w4_kernel_bench.main(["--device", "cpu", "--blocks", "256"])


def _trace(tmp_path):
    ev = lambda name, cat, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        ev("void (anonymous namespace)::paged_decode_kernel<64, 4, __nv_bfloat16>(...)",
           "kernel", 100.0, 30.0),
        ev("void (anonymous namespace)::paged_decode_kernel<64, 4, __nv_bfloat16>(...)",
           "kernel", 200.0, 10.0),
        ev("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "kernel", 140.0, 50.0),
        ev("void at::native::vectorized_elementwise_kernel<4, ...>", "kernel", 190.0, 5.0),
        ev("void at::native::reduce_kernel<512, 1, ...>", "kernel", 195.0, 4.0),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 215.0, 3.0),
        ev("Memset (Device)", "gpu_memset", 90.0, 1.0),
        ev("void something_else(int)", "kernel", 220.0, 2.0),
        ev("nvjet_tst_64x64_64x13_2x1_v_bz_TNT", "kernel", 230.0, 6.0),
        # host-side events are not device time
        ev("aten::mm", "cpu_op", 0.0, 500.0),
        ev("cudaLaunchKernel", "cuda_runtime", 99.0, 3.0),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
    ]
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_analyze_trace_sums_a_known_trace(tmp_path, capsys):
    r = analyze_trace.main([str(_trace(tmp_path)), "--top", "3"])
    assert r["busy_us"] == 111.0
    assert r["span_us"] == 236.0 - 90.0
    assert r["by_category"] == {"matmul": 56.0, "port kernel": 40.0, "elementwise": 5.0,
                                "reduce": 4.0, "copy": 3.0, "other": 2.0, "memset": 1.0}
    name = "void (anonymous namespace)::paged_decode_kernel<64, 4, __nv_bfloat16>(...)"
    assert r["by_op"][name] == (40.0, 2)
    out = capsys.readouterr().out
    assert "device busy time: 0.111 ms over a 0.146 ms span (76.0% occupancy)" in out
    assert "top 3 ops" in out and "x2" in out


def test_analyze_trace_knows_the_port_kernels():
    names = analyze_trace.port_kernel_names()
    for k in ("paged_decode_kernel", "paged_extend_kernel", "decode_ablate_kernel",
              "w4a8_gemm_kernel", "sm90_gemm_kernel", "w4a16_mma_kernel"):
        assert k in names
    assert analyze_trace.category("void decode_ablate_kernel<128, 4, 4>(...)", "kernel", names) == \
        "port kernel"
