"""ip_peers_ms (ms, program span): the mean host time a recount of the
window (portbench.recount ranges) spends in engine.ip_peers spans, which
the engine opens around the ip-peer leg of its dense precompute
(engine/tiled.py _direction_tallow), whether a whole precompute or a pin
patch's pod columns (engine.pre_patch) runs it.  None where no recount
holds such a span: a program without the leg, or whose spans are not on
the profiler's clock."""

from portbench import program_spans

IP_PEERS = "engine.ip_peers"


def read(run):
    recounts = program_spans.within(run, "recount", lambda name: name == IP_PEERS)
    if not recounts or not any(recounts):
        return None
    return 1e3 * sum(s for r in recounts for _n, s in r) / len(recounts)
