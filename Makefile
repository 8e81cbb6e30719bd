# Top-level build/test entry points (SURVEY.md §2.1 E14 — the reference's
# build system is a VS2015 solution; ours is make + pyproject).
#
#   make native    build the C++ decode layer (libpmt_native.so)
#   make test      native build + default-tier suite on a faked 8-device
#                  mesh (xdist, 2 workers — same shape as CI; a single
#                  long-lived pytest process accumulates hundreds of
#                  XLA-CPU executables and was observed to segfault in
#                  late compiles, so the tiered/xdist form is canonical)
#   make test-slow the slow tier (long SfM/SLAM sequences), xdist
#   make smoke     chip_smoke.py: the main paths on one GPU vs the CPU
#                  reference (needs a GPU; one process holds the card)
#   make bench    the benchmark harness (one JSON line)
#   make dryrun   the 8-device multi-chip sharding dry run (CPU-faked)

PYTHON ?= python

.PHONY: native test test-slow smoke bench dryrun clean

native:
	$(MAKE) -C native

test: native
	$(PYTHON) -m pytest tests/ -q -m "not slow" -n 2

test-slow: native
	$(PYTHON) -m pytest tests/ -q -m slow -n 2

smoke:
	$(PYTHON) chip_smoke.py

bench:
	$(PYTHON) bench.py

dryrun:
	$(PYTHON) __graft_entry__.py --dryrun

clean:
	$(MAKE) -C native clean
