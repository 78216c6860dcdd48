// K3 form (f), the one-pass lean gossip round, in its wide blocking
// (onepass::Cluster16x16): a non-portable cluster of 16 CTAs a stripe of
// 16 subject columns, the full-view forms parking asl only, the aligned
// forms' group-max table split over the CTAs.  It holds the shapes the
// narrow blocking of rr_onepass.cu cannot (N > 19,264: up to 115,712 in
// the full-view forms, 109,056 in the aligned ones), as the TPU kernel's
// resident form does up to N = 104,448 (gossipfs_tpu/ops/merge_pallas.py
// resident_round_blocked :2611, resident=True :2631).  The kernel and its
// launcher are rr_onepass.cu's, built here as a library of their own (its
// C functions keep their names), so that nvcc compiles its instantiations
// beside rr_onepass.cu's; rr_onepass.cu's header says what each blocking
// does and what bounds it.  Bytes: 4 B an entry in the aligned forms, 5 B
// in the full-view forms (hb read once more in step 2).
#define RR_WIDE 1
#include "rr_onepass.cu"
