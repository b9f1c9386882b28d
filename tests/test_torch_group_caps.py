"""The port's own group caps (ops/decode2.py GROUP_CAP, ops/decode3.py
GROUP_CAP_V3), set from an H100 sweep in place of the reference's v5e
figures: the decode entry points take them and hand them to the
preflights.  The preflights and the host decoder are stubbed, so no large
batch decodes here."""

import inspect

import brotli_tpu_torch
from brotli_tpu_torch.ops import decode2 as D2
from brotli_tpu_torch.ops import decode3 as D3
from brotli_tpu_torch.ops import preflight2_native as N2
from brotli_tpu_torch.ops import stage3_native as S3


def _stub_v2(monkeypatch) -> dict:
    seen = {}

    def stage(streams, device, groups=None, binned=True):
        seen["shared"] = groups
        seen["binned"] = N2.GROUP_CAP if binned else None
        return None

    monkeypatch.setattr(N2, "stage_v2_native", stage)
    monkeypatch.setattr(D2, "host_decode", lambda s: b"")
    return seen


def test_v2_driver_takes_the_port_cap(monkeypatch):
    """decode_batch_device_e2e stages at most GROUP_CAP groups: its native
    staging takes the call's groups as preflight_shared's and the port's
    GROUP_CAP as preflight_binned's max_groups."""
    seen = _stub_v2(monkeypatch)
    assert N2.GROUP_CAP is D2.GROUP_CAP
    many = [b"x"] * (D2.GROUP_CAP * 1024 + 1)
    assert D2.decode_batch_device_e2e(many, device="cpu") == [b""] * len(many)
    assert seen == {"shared": None, "binned": D2.GROUP_CAP}
    D2.decode_batch_device_e2e([b"x"] * 3000, device="cpu", groups=12)
    assert seen == {"shared": 12, "binned": D2.GROUP_CAP}
    # the default groups: the streams' own, at most GROUP_CAP
    monkeypatch.undo()
    shared = []
    monkeypatch.setattr(N2, "_lib", lambda: _Refuse(shared))
    assert N2.stage_host([b"x"] * (D2.GROUP_CAP * 1024 + 1)) is None
    assert N2.stage_host([b"x"] * 3000) is None
    assert shared == [D2.GROUP_CAP, 3]


class _Refuse:
    """A stand-in for the native library whose plan records
    preflight_shared's groups and group cap, and refuses the batch."""

    def __init__(self, shared):
        self.shared = shared

    def brotli_v2_plan(self, data, lens, n, groups, group_cap,
                       binned, *rest):
        assert group_cap == D2.GROUP_CAP and binned == 1
        self.shared.append(groups)
        return 0


def test_v3_drivers_default_to_the_port_cap(monkeypatch):
    """decode_batch_v3 and decode_batch_v3_full default max_groups to
    GROUP_CAP_V3 and hand it to the native staging, which bins
    (stage_v3_native / stage_units_v3_native); an explicit value (the
    reference's 4) goes through as given."""
    for name in ("decode_batch_v3", "decode_batch_v3_full"):
        param = inspect.signature(getattr(D3, name)).parameters["max_groups"]
        assert param.default == D3.GROUP_CAP_V3
    seen = []
    monkeypatch.setattr(S3, "stage_v3_native",
                        lambda *a, max_groups, **k: seen.append(max_groups))
    monkeypatch.setattr(S3, "stage_units_v3_native",
                        lambda *a, max_groups, **k: seen.append(max_groups))
    monkeypatch.setattr(D3, "host_decode",
                        lambda s, custom_dictionary=None: b"")
    stream = brotli_tpu_torch.host_encode(b"hello, hello world " * 20,
                                          quality=5)
    D3.decode_batch_v3([stream], device="cpu")
    D3.decode_batch_v3_full([stream], device="cpu")
    D3.decode_batch_v3([stream], device="cpu", max_groups=4)
    D3.decode_batch_v3_full([stream], device="cpu", max_groups=4)
    assert seen == [D3.GROUP_CAP_V3, D3.GROUP_CAP_V3, 4, 4]
