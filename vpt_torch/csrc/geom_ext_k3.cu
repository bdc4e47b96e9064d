// Kernel K4 with 3 tangent planes and the extended estimators
// (equi-angular, nee off, physical, a baked HG g: GeomParams at run time);
// csrc/geom.cu's vpt_geom_fwd_ext dispatches to it.
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_EXT_LAUNCHER(3) { return launch_ext<3>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
