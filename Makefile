# libdogleg_tpu build/verify contract — the analog of the reference's
# Makefile check target (reference Makefile:30-32), extended with the
# GPU smoke run.

.PHONY: check test smoke

check:
	./check.sh

test:
	python -m pytest tests/ -x -q

# the main path on one GPU (exits non-zero without one)
smoke:
	python chip_smoke.py
