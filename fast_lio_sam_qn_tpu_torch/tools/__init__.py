"""Drivers of the port on the card: the benchmark's keyframe store
(``bench_pair``) and the per-stage profile of one attempt
(``profile_match``)."""
