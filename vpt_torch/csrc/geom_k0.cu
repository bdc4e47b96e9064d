// Kernel K4 with 0 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_LAUNCHER(0) { return launch<0>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
