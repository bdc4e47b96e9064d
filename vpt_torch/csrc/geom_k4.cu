// Kernel K4 with 4 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_LAUNCHER(4) { return launch<4>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
