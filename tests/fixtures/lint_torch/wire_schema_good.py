"""Fixture (the port's copy): dicts that merely LOOK close to envelopes (none flagged)."""


def kv_entry(k_pool, v_pool):
    # the KV pools: "v" binds an array, not a version string
    return {"k": k_pool, "v": v_pool}


def feature_flags():
    return {"v": False, "hedge": True}   # bool, not a version tag


def typed_send(ep, schemas, req):
    return ep.execute("generate", schemas.to_wire(req))
