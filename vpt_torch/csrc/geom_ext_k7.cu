// Kernel K4 with 7 tangent planes and the extended estimators
// (equi-angular, nee off, physical, a baked HG g: GeomParams at run time);
// csrc/geom.cu's vpt_geom_fwd_ext dispatches to it.
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_INSTANCE(7, true, false);

}  // namespace geom
}  // namespace vpt
