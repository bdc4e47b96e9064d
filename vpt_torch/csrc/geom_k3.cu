// Kernel K4 with 3 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_INSTANCE(3, false, false);

}  // namespace geom
}  // namespace vpt
