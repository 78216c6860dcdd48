// K3 form (f), the one-pass lean gossip round, in its wide blocking
// (onepass::Cluster16x16): a non-portable cluster of 16 CTAs a stripe of
// 16 subject columns, the full-view forms parking asl only, the aligned
// forms' group-max table split over the CTAs.  It holds the shapes the
// narrow blocking of rr_onepass.cu cannot (N > 19,264: up to 115,712 in
// the full-view forms, 109,056 in the aligned ones), as the TPU kernel's
// resident form does up to N = 104,448 (gossipfs_tpu/ops/merge_pallas.py
// resident_round_blocked :2611, resident=True :2631).  The kernel and its
// launcher are rr_onepass.cu's, built here as a library of its own (its
// C functions keep their names), so that nvcc compiles its instantiations
// beside rr_onepass.cu's; rr_onepass.cu's header says what each blocking
// does and what bounds it.
//
// Bound: 4 B an entry in the aligned forms, 5 B in the full-view forms (hb
// read once more in step 2): 5.13 / 6.41 ms at N = 65,536 at 3.35 TB/s.
// Its pace is set by how the memory system takes 16-byte pieces of rows
// 64 KB apart (~550-600 GB/s) and, in the full-view forms, by the
// gathers through distributed shared memory.  What the wide blocking does
// beyond rr_onepass.cu's walk: the clusters' lockstep in the aligned forms
// (lockstep, its turns in the words after the per-receiver counts), a
// 128-byte L2 prefetch on every lane read from device memory, and a
// step-2 thread's receiver rows held across its stripes (rr_onepass.cuh
// Hold).  The full-view gathers issued a row ahead (each receiver's first
// 8 view-row loads and its hb read in flight while the row before it
// merges) were timed and left out: no gain where they spill nothing
// (edges, lanes, crash-only), 200 B of spills and +11 % in SWAR (PERF.md
// section 6), so the gathers' latency is not what step 2 waits on.
#define RR_WIDE 1
#include "rr_onepass.cu"
