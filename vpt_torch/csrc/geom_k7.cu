// Kernel K4 with 7 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_LAUNCHER(7) { return launch<7>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
