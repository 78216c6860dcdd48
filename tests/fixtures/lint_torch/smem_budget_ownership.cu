// Trigger fixture for the smem-budget-ownership rule: a launcher whose
// dynamic shared memory is a literal and a local sum instead of a budget
// function of a csrc/*.cuh header, so the budget probe cannot reconcile it
// with the Python formula the route admits shapes by.  Mounted as
// gossipfs_tpu_torch/csrc/_lint_fixture.cu by tests/test_torch_analysis.py
// only -- never compiled.

template <bool kSus>
cudaError_t launch(const Params& p, cudaStream_t s) {
  auto kern = fixture_kernel<kSus>;
  // a local sum: the park re-derived beside the kernel
  const size_t smem = (size_t)(p.n / 16) * 128 + 2 * 640 * 4;
  cudaLaunchConfig_t cfg = {};
  cfg.dynamicSmemBytes = smem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 48 * 1024);
  if (e != cudaSuccess) return e;
  other_kernel<<<p.n / 256, 256, 16384, s>>>(p);
  return cudaLaunchKernelEx(&cfg, kern, p);
}
