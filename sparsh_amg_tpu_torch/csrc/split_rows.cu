// The limits of the split-row launch (split_rows.cuh), for the wrapper's
// launch chooser (ops/split_rows.py), which reads them from here so that
// they are stated once.
#include "split_rows.cuh"

extern "C" int split_max_lanes() { return split::kMaxLanes; }
extern "C" int split_max_cluster() { return split::kMaxCluster; }
