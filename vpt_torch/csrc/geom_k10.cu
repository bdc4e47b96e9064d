// Kernel K4 with 10 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_LAUNCHER(10) { return launch<10>(G, theta, seed, base, n_out, out, stream); }

}  // namespace geom
}  // namespace vpt
