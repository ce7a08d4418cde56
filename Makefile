# aerobulk_tpu build/test driver (replaces the reference's Makefile+arch layer:
# there is nothing to compile on the Python side; native targets cover cpp/).

PY ?= python3

.PHONY: test test-fast bench bench-all bench-matrix bench-matrix-torch baseline roofline cpp cpp-example toy clean

test:
	$(PY) -m pytest tests/ -x -q

test-fast:   # core correctness in <3 min; the slow marker holds the depth tests
	$(PY) -m pytest tests/ -x -q -m "not slow"

test-slow:   # just the depth tests (fuzz, long-series, heavy AD, sharded scans)
	$(PY) -m pytest tests/ -x -q -m "slow"

bench:
	$(PY) bench.py

bench-all:
	$(PY) bench.py --all

bench-matrix:   # full pinned matrix (--all, --niter 20, --bf16) -> docs/BENCH_ALL.json
	$(PY) tools/pin_bench_matrix.py "$$(date -u +%Y-%m-%dT%H:%MZ) $$(git rev-parse --short HEAD)"

bench-matrix-torch:   # the port's pinned matrix on the card -> docs/BENCH_TORCH_ALL.json
	$(PY) -m aerobulk_tpu_torch.pin_bench_matrix --commit "$$(git describe --always --dirty)"

baseline:   # measured single-core CPU baseline (C transcription)
	cc -O3 -march=native -ffast-math -o bench_baseline/coare36_skin_baseline \
	  bench_baseline/coare36_skin_baseline.c -lm
	./bench_baseline/coare36_skin_baseline 200000 5

roofline:   # op census + VPU ceiling -> docs/ROOFLINE.json (run on TPU)
	$(PY) tools/run_roofline.py

cpp:
	cmake -S cpp -B cpp/build -G Ninja -DCMAKE_BUILD_TYPE=Release
	ninja -C cpp/build

cpp-example: cpp
	PYTHONPATH=$(CURDIR):$$PYTHONPATH ./cpp/build/example_call_aerobulk

.PHONY: cpp-torch
cpp-torch:   # the C++ binding of aerobulk_tpu_torch (run: python3 -m aerobulk_tpu_torch.cxx)
	cmake -S cpp_torch -B cpp_torch/build -G Ninja -DCMAKE_BUILD_TYPE=Release
	ninja -C cpp_torch/build

toy:
	$(PY) -m aerobulk_tpu.cli toy

clean:
	rm -rf cpp/build aerobulk_tpu/__pycache__ tests/__pycache__
