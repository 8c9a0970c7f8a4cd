"""Embedded hanzi -> toneless-pinyin table for word-level SVS input (the
port's own copy of diffsinger_tpu/data/text/hanzi_pinyin.py).

The word-level SVS frontend converts lyrics to pinyin with pypinyin where it
is installed; where it is not, ``lazy_pinyin_fallback`` mimics the subset
of ``pypinyin.lazy_pinyin(strict=False)`` the frontend relies on over a
small hand-vetted table (the demo sentences plus common unambiguous
characters): hanzi become toneless pinyin, and runs of non-hanzi characters
pass through as single chunks, so 'AP' / 'SP' breath marks survive intact.
Polyphonic characters carry pypinyin's untoned default reading.
"""

from __future__ import annotations

from typing import List

# char -> toneless pinyin. Grouped by source; every entry hand-checked.
HANZI_PINYIN = {
    # -- gradio demo sentence 1: 你说你不懂为何在这时牵手
    "你": "ni", "说": "shuo", "不": "bu", "懂": "dong", "为": "wei",
    "何": "he", "在": "zai", "这": "zhe", "时": "shi", "牵": "qian",
    "手": "shou",
    # -- demo sentence 2: 小酒窝长睫毛是你最美的记号 (+常 via polyphone fix)
    "小": "xiao", "酒": "jiu", "窝": "wo", "长": "chang", "常": "chang",
    "睫": "jie", "毛": "mao", "是": "shi", "最": "zui", "美": "mei",
    "的": "de", "记": "ji", "号": "hao",
    # -- demo sentence 3: 我真的爱你句句不轻易
    "我": "wo", "真": "zhen", "爱": "ai", "句": "ju", "轻": "qing",
    "易": "yi",
    # -- demo sentence 4: 好冷啊我在东北玩泥巴
    "好": "hao", "冷": "leng", "啊": "a", "东": "dong", "北": "bei",
    "玩": "wan", "泥": "ni", "巴": "ba",
    # -- common characters (numerals, pronouns, frequent lyric vocabulary)
    "一": "yi", "二": "er", "三": "san", "四": "si", "五": "wu",
    "六": "liu", "七": "qi", "八": "ba", "九": "jiu", "十": "shi",
    "百": "bai", "千": "qian", "万": "wan", "零": "ling",
    "他": "ta", "她": "ta", "它": "ta", "们": "men", "自": "zi",
    "己": "ji", "人": "ren", "心": "xin", "情": "qing", "梦": "meng",
    "想": "xiang", "念": "nian", "忘": "wang", "住": "zhu",
    "天": "tian", "地": "di", "上": "shang", "下": "xia", "中": "zhong",
    "大": "da", "来": "lai", "去": "qu", "回": "hui", "走": "zou",
    "飞": "fei", "跑": "pao", "站": "zhan", "坐": "zuo", "看": "kan",
    "听": "ting", "见": "jian", "闻": "wen", "唱": "chang", "歌": "ge",
    "声": "sheng", "音": "yin", "词": "ci", "曲": "qu",
    "风": "feng", "雨": "yu", "雪": "xue", "云": "yun", "雷": "lei",
    "星": "xing", "月": "yue", "日": "ri", "光": "guang", "影": "ying",
    "明": "ming", "暗": "an", "夜": "ye", "晚": "wan", "早": "zao",
    "春": "chun", "夏": "xia", "秋": "qiu", "冬": "dong", "年": "nian",
    "山": "shan", "海": "hai", "河": "he", "江": "jiang", "湖": "hu",
    "水": "shui", "火": "huo", "花": "hua", "草": "cao", "树": "shu",
    "叶": "ye", "果": "guo", "木": "mu", "石": "shi", "土": "tu",
    "金": "jin", "银": "yin", "白": "bai", "黑": "hei", "红": "hong",
    "蓝": "lan", "绿": "lv", "黄": "huang", "紫": "zi", "色": "se",
    "眼": "yan", "泪": "lei", "笑": "xiao", "哭": "ku", "脸": "lian",
    "口": "kou", "耳": "er", "头": "tou", "身": "shen", "体": "ti",
    "前": "qian", "后": "hou", "左": "zuo", "右": "you", "西": "xi",
    "南": "nan", "里": "li", "外": "wai", "内": "nei", "间": "jian",
    "边": "bian", "远": "yuan", "近": "jin", "高": "gao", "低": "di",
    "多": "duo", "少": "shao", "新": "xin", "旧": "jiu", "快": "kuai",
    "慢": "man", "热": "re", "暖": "nuan", "凉": "liang", "甜": "tian",
    "苦": "ku", "香": "xiang", "深": "shen", "浅": "qian", "满": "man",
    "空": "kong", "有": "you", "无": "wu", "没": "mei", "要": "yao",
    "会": "hui", "能": "neng", "可": "ke", "以": "yi", "就": "jiu",
    "才": "cai", "又": "you", "再": "zai", "还": "hai", "也": "ye",
    "都": "dou", "很": "hen", "太": "tai", "更": "geng", "只": "zhi",
    "让": "rang", "给": "gei", "把": "ba", "被": "bei", "和": "he",
    "与": "yu", "同": "tong", "别": "bie", "过": "guo", "了": "le",
    "着": "zhe", "呢": "ne", "吧": "ba", "吗": "ma", "呀": "ya",
    "到": "dao", "从": "cong", "向": "xiang", "对": "dui", "错": "cuo",
    "开": "kai", "关": "guan", "门": "men", "窗": "chuang", "家": "jia",
    "国": "guo", "城": "cheng", "路": "lu", "街": "jie", "桥": "qiao",
    "车": "che", "船": "chuan", "马": "ma", "鸟": "niao", "鱼": "yu",
    "朋": "peng", "友": "you", "亲": "qin", "母": "mu", "父": "fu",
    "儿": "er", "女": "nv", "子": "zi", "孩": "hai", "生": "sheng",
    "死": "si", "老": "lao", "青": "qing",
    "幸": "xing", "福": "fu", "伤": "shang", "痛": "tong", "悲": "bei",
    "喜": "xi", "怒": "nu", "哀": "ai", "欢": "huan", "离": "li",
    "合": "he", "聚": "ju", "散": "san", "相": "xiang", "思": "si",
    "恋": "lian", "吻": "wen", "抱": "bao", "拥": "yong", "等": "deng",
    "待": "dai", "陪": "pei", "伴": "ban", "永": "yong", "恒": "heng",
    "温": "wen", "柔": "rou", "孤": "gu", "单": "dan", "寂": "ji",
    "寞": "mo", "安": "an", "静": "jing", "平": "ping", "淡": "dan",
    "流": "liu", "浪": "lang", "漂": "piao", "游": "you", "旅": "lv",
    "途": "tu", "世": "shi", "界": "jie", }


def lazy_pinyin_fallback(text: str) -> List[str]:
    """``pypinyin.lazy_pinyin(text, strict=False)`` over the embedded table.

    Hanzi map to toneless pinyin, one item per character; maximal runs of
    non-hanzi characters (breath marks, spaces, punctuation, latin) become one
    item each, exactly as pypinyin chunks them. Hanzi absent from the table
    raise with the missing characters named, instead of pypinyin's silent
    pass-through (which would surface downstream as a confusing word/notes
    count mismatch).
    """
    out: List[str] = []
    chunk: List[str] = []
    missing: List[str] = []
    for ch in text:
        if "\u4e00" <= ch <= "\u9fff":
            if chunk:
                out.append("".join(chunk))
                chunk = []
            py = HANZI_PINYIN.get(ch)
            if py is None:
                missing.append(ch)
            else:
                out.append(py)
        else:
            chunk.append(ch)
    if chunk:
        out.append("".join(chunk))
    if missing:
        raise KeyError(
            f"characters not in the embedded hanzi->pinyin table: "
            f"{''.join(sorted(set(missing)))} — install pypinyin for full "
            f"coverage, or use input_type='phoneme'")
    return out
