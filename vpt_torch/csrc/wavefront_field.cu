// K1 in an analytic density field, free-flight distance sampling with NEE
// (explicit_free, iterative_vpt_free, explicit_free_physical): the
// instantiation foggy_cornell and blob_cloud render through. The kernel is in
// csrc/wavefront_kernel.cuh, the field code in csrc/field.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_ENTRY(vpt_wavefront_free_nee_field, true, vpt::kFree, true)
