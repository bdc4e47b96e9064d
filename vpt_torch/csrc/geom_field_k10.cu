// Kernel K4 with 10 tangent planes in a density field (exp_height or
// blobs in dual form, under every estimator: GeomParams at run time);
// csrc/geom.cu's vpt_geom_fwd_field dispatches to it.
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_INSTANCE(10, true, true);

}  // namespace geom
}  // namespace vpt
