// Kernel K4 with 3 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_LAUNCHER(3) { return launch<3>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
