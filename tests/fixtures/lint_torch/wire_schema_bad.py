"""Fixture (the port's copy): ad-hoc wire envelopes (all flagged)."""
API_VERSION = "v1"


def send_abort(ep, rid):
    return ep.execute("abort", {"v": "v1", "request_id": rid})


def send_fake_envelope(ep):
    return ep.execute("generate", {"kind": "completion.request", "data": {}})


def send_const(ep, rid):
    return ep.execute("abort", {"v": API_VERSION, "request_id": rid})
