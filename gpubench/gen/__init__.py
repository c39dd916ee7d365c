"""The benchmark's history generators, frozen copies of the port's
``collector/`` so that a change to the program cannot change what the
benchmark sends it.  Each generator module has ``make(params, seed,
index)``, which returns history ``index`` of a pool as JSONL; a traffic
mix names its module."""
