"""The port's own group caps (ops/decode2.py GROUP_CAP, ops/decode3.py
GROUP_CAP_V3), set from an H100 sweep in place of the reference's v5e
figures: the decode entry points take them and hand them to the
preflights.  The preflights and the host decoder are stubbed, so no large
batch decodes here."""

import inspect

import brotli_tpu_torch
from brotli_tpu_torch.ops import decode2 as D2
from brotli_tpu_torch.ops import decode3 as D3


def _stub_v2(monkeypatch) -> dict:
    seen = {}

    def shared(streams, groups=1, rate_sort=False):
        seen["shared"] = groups
        return None

    def binned(streams, max_groups=None):
        seen["binned"] = max_groups
        return None

    monkeypatch.setattr(D2, "preflight_shared", shared)
    monkeypatch.setattr(D2, "preflight_binned", binned)
    monkeypatch.setattr(D2, "host_decode", lambda s: b"")
    return seen


def test_v2_driver_takes_the_port_cap(monkeypatch):
    """decode_batch_device_e2e stages at most GROUP_CAP groups, and hands
    GROUP_CAP to preflight_binned as max_groups."""
    seen = _stub_v2(monkeypatch)
    many = [b"x"] * (D2.GROUP_CAP * 1024 + 1)
    assert D2.decode_batch_device_e2e(many, device="cpu") == [b""] * len(many)
    assert seen == {"shared": D2.GROUP_CAP, "binned": D2.GROUP_CAP}
    D2.decode_batch_device_e2e([b"x"] * 3000, device="cpu")
    assert seen == {"shared": 3, "binned": D2.GROUP_CAP}
    D2.decode_batch_device_e2e([b"x"] * 3000, device="cpu", groups=12)
    assert seen == {"shared": 12, "binned": D2.GROUP_CAP}


def test_v3_drivers_default_to_the_port_cap(monkeypatch):
    """decode_batch_v3 and decode_batch_v3_full default max_groups to
    GROUP_CAP_V3 and hand it to the binning (preflight_v3_native /
    preflight_units_v3_native); an explicit value (the reference's 4) goes
    through as given."""
    for name in ("decode_batch_v3", "decode_batch_v3_full"):
        param = inspect.signature(getattr(D3, name)).parameters["max_groups"]
        assert param.default == D3.GROUP_CAP_V3
    seen = []
    monkeypatch.setattr(D3, "preflight_v3_native",
                        lambda streams, max_groups: seen.append(max_groups))
    monkeypatch.setattr(D3, "preflight_units_v3_native",
                        lambda units, max_groups: seen.append(max_groups))
    monkeypatch.setattr(D3, "host_decode",
                        lambda s, custom_dictionary=None: b"")
    stream = brotli_tpu_torch.host_encode(b"hello, hello world " * 20,
                                          quality=5)
    D3.decode_batch_v3([stream], device="cpu")
    D3.decode_batch_v3_full([stream], device="cpu")
    D3.decode_batch_v3([stream], device="cpu", max_groups=4)
    D3.decode_batch_v3_full([stream], device="cpu", max_groups=4)
    assert seen == [D3.GROUP_CAP_V3, D3.GROUP_CAP_V3, 4, 4]
