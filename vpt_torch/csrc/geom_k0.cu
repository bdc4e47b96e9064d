// Kernel K4 with 0 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_INSTANCE(0, false, false);

}  // namespace geom
}  // namespace vpt
