// Kernel K4 with 6 tangent planes (csrc/geom.cu dispatches to it).
#include "geom_kernel.cuh"

namespace vpt {
namespace geom {

VPT_GEOM_INSTANCE(6, false, false);

}  // namespace geom
}  // namespace vpt
