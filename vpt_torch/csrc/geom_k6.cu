// Kernel K4 with 6 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_LAUNCHER(6) { return launch<6>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
