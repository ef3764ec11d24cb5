"""The port's own telemetry spans inside its entry points, which the JAX
package does not have, and a snapshot's spans as the reference would
record them: the tests that hold the port's telemetry to the reference's
compare that view, and check the port's sub-spans on their own."""

# each entry point's sub-spans (``factorize.sweep``, ``factorize.corner``,
# ``factorize.logdet``, ``solve.forward``, ``solve.corner``,
# ``solve.backward``, ``selinv.seed`` and ``selinv.sweep`` device-timed)
PORT_SPANS = frozenset({
    "factorize.prepare", "factorize.sweep", "factorize.corner", "factorize.logdet",
    "solve.prepare", "solve.forward", "solve.corner", "solve.backward", "solve.refine",
    "solve.assemble", "selinv.prepare", "selinv.seed", "selinv.sweep", "selinv.diagonal",
    "serving.assemble"})


def reference_view(snap: dict) -> dict:
    """``snap`` with the port's sub-spans left out and each other span's
    parent its nearest ancestor that is not one of them."""
    by_id = {s["id"]: s for s in snap["spans"]}

    def parent(s):
        p = by_id.get(s["parent"])
        while p is not None and p["name"] in PORT_SPANS:
            p = by_id.get(p["parent"])
        return None if p is None else p["id"]

    return dict(snap, spans=[dict(s, parent=parent(s)) for s in snap["spans"]
                             if s["name"] not in PORT_SPANS])


def tree(snap: dict) -> list:
    """The snapshot's spans as sorted ``(name, parent name)`` pairs."""
    names = {s["id"]: s["name"] for s in snap["spans"]}
    return sorted((s["name"], names.get(s["parent"])) for s in snap["spans"])
