# Convenience targets (see README / CLAUDE.md for details)
.PHONY: test smoke bench verify native clean

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'

# on a GPU
smoke:
	python chip_smoke.py

bench:
	python bench.py

verify:
	python __graft_entry__.py 8

native:
	cc -O2 -shared -fPIC multiphase_lbm_tpu/io/native/vtkfmt.c \
	  -o multiphase_lbm_tpu/io/native/_vtkfmt.so

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; \
	rm -f multiphase_lbm_tpu/io/native/_vtkfmt.so
