# ST-DADK framework (JAX) — developer entry points
# (role parity with the reference Makefile:49-94)

PYTHON ?= python
CPU_ENV = JAX_PLATFORMS=cpu JAX_PLATFORM_NAME=cpu

.PHONY: help install test test-fast test-slow test-cov smoke lint train grid-search \
        table44 analyze bench dryrun native clean

help:
	@echo "make install      - editable install"
	@echo "make test         - run the test suite on a virtual 8-device CPU mesh"
	@echo "make test-fast    - inner loop: the suite minus slow-marked tests"
	@echo "make test-slow    - the slow-marked integration lane (separate process)"
	@echo "make test-cov     - tests with coverage"
	@echo "make smoke        - chip_smoke.py: the main path on one GPU"
	@echo "make train        - multi-experiment training run (default config)"
	@echo "make grid-search  - full grid search (vmapped experiment batches)"
	@echo "make table44      - Table 4.4 reproduction (STDK vs DA-STDK CRPS)"
	@echo "make analyze      - analyze the latest grid-search results"
	@echo "make bench        - fits/hour benchmark vs the CPU reference baseline"
	@echo "make dryrun       - multichip sharding dry-run on 8 virtual devices"
	@echo "make native       - build the C++ ingest extension"

install:
	pip install -e .

test:
	$(PYTHON) -m pytest tests/ -x -q

# inner-loop lane: excludes the >=5s integration tests (marked slow in
# tests/conftest.py); ~3 minutes on one CPU core vs ~17 for the full suite
test-fast:
	$(PYTHON) -m pytest tests/ -x -q -m "not slow"

# the slow-marked integration lane. Run the two lanes as separate processes
# on small hosts: a single process that compiles the ENTIRE suite (~400
# XLA-CPU programs) can hit an upstream LLVM-JIT segfault near the end of
# the alphabet (reproduced on the round-5 box at test_train_loop with code
# from before AND after the round's changes — environmental, not a test
# failure; both lanes pass in separate processes).
test-slow:
	$(PYTHON) -m pytest tests/ -x -q -m "slow"

test-cov:
	$(PYTHON) -m pytest tests/ --cov=st_dadk_tpu --cov-report=term-missing

# the main path on one GPU at full width, checked against the plain
# reference (needs a GPU; exits non-zero without one)
smoke:
	$(PYTHON) chip_smoke.py

lint:
	$(PYTHON) -m py_compile $$(git ls-files '*.py')

train:
	$(PYTHON) scripts/train_st_interp.py --config configs/config_st_interp.yaml

grid-search:
	$(PYTHON) scripts/run_grid_search.py --config configs/config_st_interp.yaml

table44:
	$(PYTHON) scripts/run_table_4_4.py --n_experiments 10

analyze:
	$(PYTHON) scripts/analyze_grid_search.py

bench:
	$(PYTHON) bench.py

dryrun:
	$(CPU_ENV) XLA_FLAGS="--xla_force_host_platform_device_count=8" \
	$(PYTHON) __graft_entry__.py 8

native:
	$(MAKE) -C native

clean:
	rm -rf build dist *.egg-info .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
