"""The frozen arithmetic against PERF.md's Bound column (the kernels'
table: bytes and FLOPs counted once each, 3.35 TB/s and 67 TFLOP/s), the
card table and the trace arithmetic."""
import pytest

from benchmark.harness import device, work

BW, PEAK = 3.35e12, 67e12


def bound_ms(nbytes_flops):
    return 1e3 * work.bound_s(*nbytes_flops, BW, PEAK)


@pytest.mark.parametrize("what, got, mb, mflop, ms", [
    ("serving B=256 N=90", work.stack_work(256, 90, 3, (16, 16)),
     None, None, 0.003439),
    ("training B=32 N=90", work.stack_work(32, 90, 3, (16, 16)),
     None, None, 0.000430),
    ("multi-fusion training B=32 N=270", work.stack_work(32, 270, 1,
                                                         (10, 10, 10)),
     None, None, 0.003106),
    ("grouped 5·32 N=90", work.grouped_work(5, 32, 90, 3, (16, 16)),
     7.2, None, 0.002151),
    ("grouped 15·32 N=90", work.grouped_work(15, 32, 90, 3, (16, 16)),
     21.6, None, 0.006454),
    ("backward B=32 N=90", work.backward_work(0, 32, 90, 3, (16, 16)),
     2.51, 55.5, 0.000829),
    ("backward B=32 N=270", work.backward_work(0, 32, 270, 1, (10, 10, 10)),
     19.77, 432.3, 0.006452),
    ("grouped backward 5·32 N=90", work.backward_work(5, 32, 90, 3,
                                                      (16, 16)),
     12.57, 277.7, 0.004144),
    ("grouped backward 5·32 N=270", work.backward_work(5, 32, 270, 1,
                                                       (10, 10, 10)),
     98.85, 2161.3, 0.032259),
])
def test_bound_column(what, got, mb, mflop, ms):
    """Each figure to the digits the table gives."""
    def digits(x):
        return len(repr(x).split(".")[1])
    assert round(bound_ms(got), digits(ms)) == ms, what
    if mb is not None:
        assert round(got[0] / 1e6, digits(mb)) == mb, what
    if mflop is not None:
        assert round(got[1] / 1e6, digits(mflop)) == mflop, what


def test_card_table_knows_the_h100_and_refuses_others():
    assert device.card_spec("NVIDIA H100 80GB HBM3") == ("H100", 3.35e12,
                                                         67e12)
    assert device.card_spec("NVIDIA H100 PCIe")[1:] == (2.0e12, 51e12)
    with pytest.raises(ValueError):
        device.card_spec("NVIDIA A100-SXM4-80GB")


def test_union_of_spans_and_breakdown():
    events = [("a", 0, 10), ("b", 5, 12), ("gcn_stack_kernel", 20, 30),
              ("sum_weight_slots", 40, 41)]
    assert device.busy_us(events) == 12 + 10 + 1
    assert device.hand_kernel_us(events) == 11
    b = device.breakdown(events)
    assert b["device_ops"][0] == ["a", 10e-6]
    assert dict(b["idle_gaps"]) == {"before gcn_stack_kernel": 8e-6,
                                    "before sum_weight_slots": 10e-6}


def test_model_flops_of_one_pass():
    """A hand count of the flagship's plain pass at its published widths
    and the 436-term DAG."""
    model = {"num_layers": 2, "hidden": 16, "rois": 90, "feat_dim": 3,
             "num_classes": 2, "num_regr": 3, "hidden_linear": 64,
             "l_dim": 32, "go_in_f_dim": 2, "go_n_l": 2, "go_f_dim": [5, 5],
             "num_snps": 54}
    levels = [250, 120, 50, 15, 1]
    stack = work.stack_work(1, 90, 3, (16, 16))[1]
    go = (2 * 2 * 54 * 436                                   # encoding
          + 4 * 436 * 2 * 5 + 4 * 436 * 5 + 2 * 436 ** 2 * 5 + 2 * 436 * 5
          + 4 * 186 * 5 * 5 + 4 * 186 * 5 + 2 * 186 ** 2 * 5 + 2 * 186 * 5
          + 2 * 66 * 5 * 33 + 2 * 66 * 32 + 2 * 32 * 32       # readouts
          + 4 * 66 * 5 * 5 + 2 * 186 * 66 * 5                 # decoder
          + 4 * 186 * 5 * 2 + 2 * 436 * 186 * 2
          + 2 * 436 * 2 + 2 * 436 * 54)
    attention = 4 * 90 * 32 * 32 + 4 * 66 * 32 * 32 + 4 * 90 * 66 * 32
    heads = 2 * 2912 * 64 + 2 * 64 * 2 + 2 * 3182 * 64 + 2 * 64 * 3
    assert work.pass_flops(model, levels) == stack + go + attention + heads
    assert work.masked_pass_flops(model, levels) == \
        work.pass_flops(model, levels) + 4 * 90 * 3


def test_request_p95_is_the_nearest_rank():
    """Of 200 latencies 1..200 ms the 190th; nothing timed, no reading."""
    from benchmark.harness import registry
    reader = registry.metric_reader("request_p95_ms.serve")
    lat = [i / 1e3 for i in range(200, 0, -1)]
    assert reader.read({"request_latency_s": lat}) == pytest.approx(190.0)
    assert reader.read({"request_latency_s": []}) is None
