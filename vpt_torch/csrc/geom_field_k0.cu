// Kernel K4 with 0 tangent planes in a density field (exp_height or
// blobs in dual form, under every estimator: GeomParams at run time and, with a
// table, a voxel grid on the primal values);
// csrc/geom.cu's vpt_geom_fwd_field dispatches to it.
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_INSTANCE(0, true, true);

}  // namespace geom
}  // namespace vpt
